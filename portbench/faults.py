"""Faults planted underneath a run's measured path, to show that the
comparison that decides `correct` catches them (portbench/tests and
portbench/check_limits.py). Each is a context manager that patches the
program under test for its duration.

  unchanged   the Trainer's train step returns the state it was given;
  half_batch  the loss is taken over the top half of the image's rows
              only (the mean over the rest of the batch's pixels);
  altered     the rendered image comes out with one 16x16 tile at its
              centre set to zero, where the composite produces it;
  densify_skipped  the Trainer's densify event returns the state it was
              given, with counts of an event that did nothing;
and of the contact stage:
  search_half      the contact search sees the first half of the other
                   cloud only;
  contact_altered  the contact signal of one hand point in a hundred
                   comes out as 1 where the search produces it;
  acc_unchanged    the renderer returns the running sum it was given.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name: str, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged():
    from manus_tpu_torch.train import trainer as trainer_mod

    def make(cls):
        class Frozen(cls):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                step = self.train_step

                def same_state(state, batch):
                    return state, step(state, batch)[1]

                self.train_step = same_state
        return Frozen

    return _patched(trainer_mod, "Trainer", make)


def densify_skipped():
    import torch

    from manus_tpu_torch.train import trainer as trainer_mod

    def make(factory):
        def make_steps(*args, **kwargs):
            _, opacity_reset = factory(*args, **kwargs)

            def same_state(state):
                zero = torch.zeros((), dtype=torch.int64,
                                   device=state.model.active.device)
                return state, dict(clones=zero, splits=zero, pruned=zero,
                                   alloc_dropped=zero,
                                   num_active=state.model.active.sum())
            return same_state, opacity_reset
        return make_steps

    return _patched(trainer_mod, "make_densify_step", make)


def half_batch():
    from manus_tpu_torch.utils import losses

    def make(fn):
        def top_half(pred, gt, *args, **kwargs):
            h = pred.shape[0] // 2
            return fn(pred[:h], gt[:h], *args, **kwargs)
        return top_half

    return _patched(losses, "compute_losses", make)


@contextlib.contextmanager
def altered():
    from manus_tpu_torch.train import composite, workloads

    def make(fn):
        def render(*args, **kwargs):
            out = fn(*args, **kwargs)
            h, w = out.render.shape[:2]
            y, x = h // 2 // 16 * 16, w // 2 // 16 * 16
            img = out.render.clone()
            img[y:y + 16, x:x + 16] = 0.0
            return out._replace(render=img)
        return render

    with _patched(workloads, "render_gaussians", make), _patched(
            composite, "render_gaussians", make):
        yield


def search_half():
    from manus_tpu_torch.ops import contacts

    def make(fn):
        def half(pt1, pt2, pt1_valid=None, pt2_valid=None, **kwargs):
            m = pt2.shape[0] // 2
            return fn(pt1, pt2[:m], pt1_valid=pt1_valid,
                      pt2_valid=None if pt2_valid is None
                      else pt2_valid[:m], **kwargs)
        return half

    return _patched(contacts, "contact_map", make)


def contact_altered():
    from manus_tpu_torch.ops import contacts

    def make(fn):
        def altered_map(*args, **kwargs):
            d01, idx, colors = fn(*args, **kwargs)
            d01 = d01.clone()
            d01[::100] = 1.0
            return d01, idx, colors
        return altered_map

    return _patched(contacts, "contact_map", make)


@contextlib.contextmanager
def acc_unchanged():
    from manus_tpu_torch import main as port_main
    from manus_tpu_torch.train import composite

    def make(factory):
        def make_render(*args, **kwargs):
            render_fn = factory(*args, **kwargs)

            def same_acc(models, bone_tf, camera, cano_camera, bg, acc_dist,
                         aux_colors, stats=None):
                render, _, h_d01 = render_fn(models, bone_tf, camera,
                                             cano_camera, bg, acc_dist,
                                             aux_colors, stats=stats)
                return render, acc_dist, h_d01
            return same_acc
        return make_render

    # main.run_composite calls the name it imported
    with _patched(composite, "make_composite_render", make), _patched(
            port_main, "make_composite_render", make):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "densify_skipped": densify_skipped,
          "altered": altered, "search_half": search_half,
          "contact_altered": contact_altered, "acc_unchanged": acc_unchanged}

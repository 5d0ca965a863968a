"""The plain densify event (portbench/reference/densify.py) agrees with
the port's densify_and_prune slot for slot, on states where clones,
splits, drops and prunes all happen."""
from types import SimpleNamespace

import pytest
import torch

from portbench.drivers.common import LEAVES
from portbench.reference import densify as ref

OPTS = SimpleNamespace(densify_grad_threshold=2e-4, percent_dense=0.01,
                       min_opacity_threshold=0.005, size_threshold=20,
                       isotropic_scaling=False)


def _state(cap, n_live, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    params = dict(xyz=r(cap, 3) * 0.05, features_dc=r(cap, 1, 3),
                  features_rest=r(cap, 15, 3), scaling=r(cap, 3) - 6.0,
                  rotation=r(cap, 4), opacity=r(cap, 1) * 3.0)
    active = torch.zeros(cap, dtype=torch.bool)
    active[torch.randperm(cap, generator=g)[:n_live]] = True
    stats = dict(grad_accum=r(cap).abs() * 2e-3,
                 denom=torch.randint(0, 4, (cap,), generator=g).float(),
                 max_radii2d=r(cap).abs() * 15.0)
    m = {k: r(*p.shape) for k, p in params.items()}
    v = {k: r(*p.shape).abs() for k, p in params.items()}
    noise = r(2, cap, 3)
    return params, active, stats, m, v, noise


@pytest.mark.parametrize("n_live,size", [(200, False), (480, True),
                                         (512, False)])
def test_the_plain_event_is_the_ports(n_live, size):
    from manus_tpu_torch.models import densify as port
    from manus_tpu_torch.models.gaussians import GaussianModel, GaussianParams
    from manus_tpu_torch.train.optim import AdamState

    cap = 512
    params, active, stats, m, v, noise = _state(cap, n_live, n_live)
    model = GaussianModel(params=GaussianParams(**params), active=active,
                          skin_weights=None)
    opt = AdamState(m=GaussianParams(**m), v=GaussianParams(**v), step=9)
    got_model, got_opt, got_stats, info = port.densify_and_prune(
        model, opt, port.DensifyStats(**stats), OPTS, 1.0, noise, size)
    want = ref.densify(params, active, stats, m, v, OPTS, 1.0, noise, size)
    assert torch.equal(got_model.active, want["active"])
    assert {k: int(x) for k, x in info.items()} == want["counts"]
    for k, p in zip(LEAVES, got_model.params):
        torch.testing.assert_close(p, want["params"][k], rtol=1e-6,
                                   atol=1e-7)
    for k, x in zip(LEAVES, got_opt.m):
        assert torch.equal(x, want["m"][k])
    for k, x in zip(LEAVES, got_opt.v):
        assert torch.equal(x, want["v"][k])
    for k in stats:
        assert torch.equal(getattr(got_stats, k), want["stats"][k])
    # the states exercise every branch of the event; a full model, as at
    # hand_720p's size, drops every child for want of a slot
    c = want["counts"]
    assert c["pruned"] > 0
    assert (c["clones"] + c["splits"] > 0) == (n_live < cap)
    assert (c["alloc_dropped"] > 0) == (n_live > cap - 100)

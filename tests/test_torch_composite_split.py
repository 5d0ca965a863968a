"""The split of the composite by depth range, in plain PyTorch, on the CPU.

`composite_tiles_split_torch` and `composite_split_backward_torch` are
the model of the CUDA kernels' design: every (tile, chunk of pairs) item
on its own, a scan over a tile's chunks, a second walk of only the chunk
in which a pixel's walk stops, and a backward that starts every chunk from
the state the forward saved. Here they are held against the unsplit plain
composite (`composite_tiles_torch`, with autograd for the gradient),
against a pair-by-pair walk written in numpy, and on one scene against the
JAX package's Pallas kernel in interpret mode. Payloads are made with
numpy from a seed.

Tolerances: values 1e-5 max abs (the same float32 terms summed in another
order); gradients per payload field 1e-4 of the field's largest value;
n_walk exact (the scenes keep log T away from log(1e-4) by more than
rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.ops.rasterizer import pallas_backend
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.payload import NUM_FIELDS, NUM_LIVE
from tests.test_torch_raster import T, _jax_payload, assert_close_normalised
from tests.utils import make_test_camera, random_scene

LOG_T_EPS = np.log(1e-4)


def make_payload(seed, ntx, nty, raw_counts, cap=0, opacity=(0.05, 0.6),
                 sigma=(3.0, 12.0), flat=None):
    """A [16, P] payload whose tile t owns raw_counts[t] pair columns (cut
    to `cap` pairs where cap > 0: the counts are clamped, the offsets are
    not). Random gaussians around each tile; with flat=op every pair
    covers its tile evenly with alpha = op."""
    rng = np.random.RandomState(seed)
    raw = np.asarray(raw_counts, np.int64)
    offsets = np.concatenate([[0], np.cumsum(raw)[:-1]]).astype(np.int32)
    counts = (np.minimum(raw, cap) if cap else raw).astype(np.int32)
    p = int(raw.sum()) + 5  # a tail that belongs to no tile
    pay = np.zeros((NUM_FIELDS, p), np.float32)
    for t, (o, n) in enumerate(zip(offsets, raw)):
        x0, y0 = (t % ntx) * 16, (t // ntx) * 16
        sl = slice(o, o + n)
        pay[0, sl] = rng.uniform(x0 - 2, x0 + 18, n)
        pay[1, sl] = rng.uniform(y0 - 2, y0 + 18, n)
        if flat is None:
            s1, s2 = rng.uniform(*sigma, (2, n))
            th = rng.uniform(0, np.pi, n)
            a = np.cos(th) ** 2 / s1 ** 2 + np.sin(th) ** 2 / s2 ** 2
            c = np.sin(th) ** 2 / s1 ** 2 + np.cos(th) ** 2 / s2 ** 2
            b = np.sin(th) * np.cos(th) * (1 / s1 ** 2 - 1 / s2 ** 2)
            pay[2, sl], pay[3, sl], pay[4, sl] = a, b, c
            pay[5, sl] = rng.uniform(*opacity, n)
        else:
            pay[2, sl] = pay[4, sl] = 1e-9
            pay[5, sl] = flat
        pay[6:9, sl] = rng.uniform(0, 1, (3, n))
    pay[:NUM_LIVE, p - 5:] = rng.uniform(0.1, 1, (NUM_LIVE, 5))
    return pay, offsets, counts


def walk_numpy(pay, offsets, counts, ntx, nty):
    """The composite pair by pair, as the kernels' header states it."""
    t = ntx * nty
    rgb = np.zeros((t, 3, 256), np.float32)
    log_t = np.zeros((t, 256), np.float32)
    n_walk = np.zeros((t, 256), np.int32)
    i = np.arange(256)
    for tile in range(t):
        px = ((tile % ntx) * 16 + i % 16).astype(np.float32)
        py = ((tile // ntx) * 16 + i // 16).astype(np.float32)
        lt = np.zeros(256, np.float32)
        done = np.zeros(256, bool)
        for j in range(counts[tile]):
            f = pay[:, offsets[tile] + j]
            dx, dy = px - f[0], py - f[1]
            power = -0.5 * (f[2] * dx * dx + f[4] * dy * dy) - f[3] * dx * dy
            alpha = np.minimum(f[5] * np.exp(power), np.float32(0.99))
            gate = (power <= 0) & (alpha >= np.float32(1 / 255)) & ~done
            lt_after = lt + np.log1p(-np.where(gate, alpha, 0)).astype(np.float32)
            stop = gate & ~(lt_after >= np.float32(LOG_T_EPS))
            done |= stop
            inc = gate & ~stop
            w = np.where(inc, alpha * np.exp(lt), 0).astype(np.float32)
            rgb[tile] += w[None, :] * f[6:9, None]
            lt = np.where(inc, lt_after, lt)
            n_walk[tile] = np.where(inc, j + 1, n_walk[tile])
        log_t[tile] = lt
    return rgb, log_t, n_walk


def run_split(pay, offsets, counts, ntx, nty, chunk):
    return composite.composite_tiles_split_torch(
        T(pay), T(offsets, torch.int32), T(counts, torch.int32), ntx, nty, chunk)


def check_against_plain(pay, offsets, counts, ntx, nty, chunk, seed=0):
    """The split model's values and gradient against the unsplit plain
    version and its autograd; returns the split's outputs."""
    rgb, tfin, log_t, n_walk, state = run_split(pay, offsets, counts, ntx,
                                                nty, chunk)
    tpay = T(pay).requires_grad_(True)
    toffs, tcnts = T(offsets, torch.int32), T(counts, torch.int32)
    rgb_p, tfin_p = composite.composite_tiles_torch(tpay, toffs, tcnts, ntx, nty)
    assert (rgb - rgb_p.detach()).abs().max().item() <= 1e-5
    assert (tfin - tfin_p.detach()).abs().max().item() <= 1e-5
    rgb_w, log_t_w, n_walk_w = walk_numpy(pay, offsets, counts, ntx, nty)
    np.testing.assert_array_equal(n_walk.numpy(), n_walk_w)
    assert np.abs(log_t.numpy() - log_t_w).max() <= 1e-5
    assert np.abs(rgb.numpy() - rgb_w).max() <= 1e-5

    rng = np.random.RandomState(seed)
    d_rgb = T(rng.normal(size=rgb.shape).astype(np.float32))
    d_tfin = T(rng.normal(size=tfin.shape).astype(np.float32))
    (want,) = torch.autograd.grad([rgb_p, tfin_p], [tpay], [d_rgb, d_tfin])
    got = composite.composite_split_backward_torch(
        tpay.detach(), toffs, tcnts, ntx, nty, chunk, d_rgb, d_tfin, tfin,
        log_t, n_walk, state)
    assert not got[NUM_LIVE:].any()
    for f in range(NUM_LIVE):
        scale = want[f].abs().max().item()
        assert scale > 0, f"field {f}: the reference gradient is all zero"
        err = (got[f] - want[f]).abs().max().item() / scale
        assert err <= 1e-4, f"field {f}: normalised err {err}"
    return rgb, tfin, log_t, n_walk, state


# (name, tiles x, tiles y, raw counts, chunk, per-tile cap)
RANDOM_CASES = [
    ("deeper_than_3_chunks", 1, 1, [37], 8, 0),
    ("exact_multiple_of_chunk", 1, 1, [32], 8, 0),
    ("one_more_than_a_multiple", 1, 1, [33], 8, 0),
    ("single_chunk_tiles", 2, 1, [7, 5], 8, 0),
    ("empty_tiles_between_deep_ones", 2, 2, [41, 0, 0, 29], 8, 0),
    ("per_tile_cap_cuts_the_segment", 2, 1, [50, 30], 8, 24),
    ("chunk_of_one_pair", 1, 1, [9], 1, 0),
]


@pytest.mark.parametrize("name,ntx,nty,raw,chunk,cap", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_split_matches_plain(name, ntx, nty, raw, chunk, cap):
    pay, offsets, counts = make_payload(len(name), ntx, nty, raw, cap)
    _, tfin, _, n_walk, state = check_against_plain(pay, offsets, counts, ntx,
                                                    nty, chunk)
    assert tfin.min().item() < 0.5  # the scene covers something
    n_chunks = -(-counts.astype(np.int64) // chunk)
    np.testing.assert_array_equal(
        state.item_start.numpy(), np.concatenate([[0], np.cumsum(n_chunks)]))
    assert int(n_walk.max()) <= int(counts.max())
    if cap:
        assert int(n_walk.max()) == cap  # the walk reaches the cut


@pytest.mark.parametrize("seed", [0, 1])
def test_split_saturating_tile(seed):
    """Opaque gaussians: the pixels stop in different chunks, and no later
    chunk adds anything."""
    pay, offsets, counts = make_payload(seed, 1, 1, [60], opacity=(0.3, 0.95),
                                        sigma=(4.0, 10.0))
    _, tfin, _, n_walk, state = check_against_plain(pay, offsets, counts, 1, 1, 8)
    stop_chunk = (n_walk.long() - 1) // 8
    assert len(torch.unique(stop_chunk[0])) >= 3
    assert int(n_walk.max()) < 60 and tfin.max().item() < 0.01


# Flat pairs of alpha 1 - exp(-0.75): log T falls by 0.75 a pair, so 12
# pairs are included (log T = -9.0) and pair 12 is the first left out.
# The chunk size puts the last included pair (index 11) and the pair that
# stops the walk (index 12) at a chunk's last and first place.
FLAT_ALPHA = 1.0 - np.exp(-0.75)
STOP_CASES = [
    ("stop_pair_first_of_chunk_3", 4),   # included 8..11 end chunk 2
    ("last_included_first_of_chunk_1", 11),
    ("last_included_last_of_chunk_0", 12),
    ("stops_inside_chunk_0", 13),
    ("last_included_last_of_chunk_1", 6),
]


@pytest.mark.parametrize("name,chunk", STOP_CASES, ids=[c[0] for c in STOP_CASES])
def test_split_stop_at_chunk_edges(name, chunk):
    pay, offsets, counts = make_payload(3, 1, 1, [30], flat=FLAT_ALPHA)
    _, tfin, log_t, n_walk, state = check_against_plain(
        pay, offsets, counts, 1, 1, chunk)
    assert (n_walk == 12).all()
    assert np.abs(log_t.numpy() + 9.0).max() <= 1e-4
    # chunks behind the stop added nothing
    first_behind = 12 // chunk + 1
    assert not state.saved[first_behind:, 1:].any()


def test_split_opaque_within_chunk_0():
    """alpha 0.8: five pairs take log T to -8.05, the sixth is left out.
    n_walk stays in chunk 0 and the 3 later chunks add nothing."""
    pay, offsets, counts = make_payload(4, 1, 1, [30], flat=0.8)
    _, _, _, n_walk, state = check_against_plain(pay, offsets, counts, 1, 1, 8)
    assert (n_walk == 5).all()
    assert state.saved[0, 1:].abs().max().item() > 0
    assert not state.saved[1:, 1:].any()


def test_split_chunk_sizes_agree():
    """Chunks of 4 and of 64 pairs: equal n_walk, values within 1e-5."""
    pay, offsets, counts = make_payload(7, 2, 2, [70, 3, 0, 130],
                                        opacity=(0.02, 0.2))
    a = run_split(pay, offsets, counts, 2, 2, 4)
    b = run_split(pay, offsets, counts, 2, 2, 64)
    assert torch.equal(a[3], b[3]) and int(a[3].max()) > 64
    for x, y in zip(a[:3], b[:3]):
        assert (x - y).abs().max().item() <= 1e-5


def test_split_walk_that_does_not_stop_goes_on(monkeypatch):
    """With a margin on the rule that sends a chunk to its second walk,
    chunks are walked that do not end the pixel: it must go on with the
    next chunk and give the same result."""
    pay, offsets, counts = make_payload(9, 1, 1, [48], opacity=(0.2, 0.9))
    want = run_split(pay, offsets, counts, 1, 1, 8)
    monkeypatch.setattr(composite, "STOP_MARGIN", 3.0)
    got = check_against_plain(pay, offsets, counts, 1, 1, 8)
    assert torch.equal(want[3], got[3])
    assert (want[0] - got[0]).abs().max().item() <= 1e-5


def test_split_matches_pallas_interpret():
    """The split model against composite_tiles_pallas(interpret=True) on
    the scene of tests/test_torch_raster.py, forward and VJP: normalised
    max abs 1e-4, as that test holds the unsplit plain version."""
    cam = make_test_camera(32, 32)
    s = random_scene(160, seed=11)
    pay, bins = _jax_payload(s, cam)
    rng = np.random.RandomState(0)
    d_rgb = rng.normal(size=(4, 3, 256)).astype(np.float32)
    d_tfin = rng.normal(size=(4, 256)).astype(np.float32)
    (rgb_j, tf_j), vjp = jax.vjp(
        lambda p: pallas_backend.composite_tiles_pallas(
            p, bins.tile_offsets, bins.tile_counts, 2, 2, tile=16, chunk=64,
            interpret=True),
        pay)
    (dpay_j,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_tfin)))

    offs, cnts = T(bins.tile_offsets, torch.int32), T(bins.tile_counts, torch.int32)
    assert int(cnts.max()) > 3 * 16
    rgb, tfin, log_t, n_walk, state = composite.composite_tiles_split_torch(
        T(pay), offs, cnts, 2, 2, 16)
    dpay = composite.composite_split_backward_torch(
        T(pay), offs, cnts, 2, 2, 16, T(d_rgb), T(d_tfin), tfin, log_t, n_walk,
        state)
    assert_close_normalised(rgb_j, rgb, 1e-4, "rgb")
    assert_close_normalised(1 - np.asarray(tf_j), 1 - tfin.numpy(), 1e-4,
                            "t_final")
    assert_close_normalised(dpay_j, dpay, 1e-4, "d_payload")

"""The port's level histogram (``hist_cuda.level_histogram`` on the CPU,
which runs its plain version) against the JAX package's: the XLA
``per_feature`` formulation of ``trainer._level_histogram`` and the
Pallas kernel ``pallas_level_histogram`` in interpret mode.

Tolerances: float stats ``rtol=1e-5, atol=1e-4`` (sums taken in another
order), counts exact; integer-valued stats bit for bit (every partial
sum is exact in float32, so order cannot matter).

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there. Here the tile plan and the CTA
walk of ``csrc/level_hist.cu`` are replayed in numpy to pin the
kernel's indexing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.hist_pallas import pallas_level_histogram
from mmlspark_tpu.models.gbdt.trainer import _level_histogram
from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

SHAPES = [
    (2000, 7, 32, 4),     # generic
    (999, 3, 255, 8),     # n not divisible by a block, full bin range
    (100, 5, 16, 16),     # more nodes than rows per node; empty nodes
    (4096, 2, 64, 1),     # single node (root level)
]


@pytest.fixture(autouse=True)
def _pin_formulation(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.delenv("MMLSPARK_TPU_PALLAS_HIST", raising=False)


def _case(n, f, b, width, seed=0, integer_stats=False):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    if integer_stats:
        grad = rng.integers(-8, 9, size=n).astype(np.float32)
        hess = rng.integers(1, 9, size=n).astype(np.float32)
    else:
        grad = rng.normal(size=n).astype(np.float32)
        hess = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    live = (rng.random(n) < 0.9).astype(np.float32)
    local = rng.integers(0, width, size=n).astype(np.int32)
    return binned, grad, hess, live, local


def _jax(ref, arrays, width, f, b):
    a = [jnp.asarray(x) for x in arrays]
    if ref == "xla":
        return np.asarray(_level_histogram(*a, width, f, b))
    return np.asarray(pallas_level_histogram(*a, width, f, b,
                                             interpret=True))


def _port(arrays, width, f, b):
    t = [torch.from_numpy(x) for x in arrays]
    out = H.level_histogram(*t, width, f, b)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n,f,b,width", SHAPES)
def test_matches_jax_histogram(ref, n, f, b, width):
    arrays = _case(n, f, b, width)
    want = _jax(ref, arrays, width, f, b)
    got = _port(arrays, width, f, b)
    assert got.shape == want.shape == (width, f, b, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n,f,b,width", SHAPES)
def test_bitwise_on_integer_stats(ref, n, f, b, width):
    arrays = _case(n, f, b, width, seed=1, integer_stats=True)
    np.testing.assert_array_equal(_port(arrays, width, f, b),
                                  _jax(ref, arrays, width, f, b))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_skewed_node_distribution(ref):
    """One dominant node and several empty ones: empty nodes come back
    exactly zero."""
    rng = np.random.default_rng(7)
    n, f, b, width = 2500, 3, 32, 8
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    live = np.ones(n, np.float32)
    local = np.where(rng.random(n) < 0.95, 3, 6).astype(np.int32)
    arrays = (binned, grad, hess, live, local)
    got = _port(arrays, width, f, b)
    np.testing.assert_allclose(got, _jax(ref, arrays, width, f, b),
                               rtol=1e-5, atol=1e-4)
    for w in (0, 1, 2, 4, 5, 7):
        assert not np.any(got[w])


def _replay_kernel(binned, grad, hess, live, local, width, f, b, tile_rows):
    """numpy replay of level_hist.cu: one CTA per (tile, feature slice)
    over the wrapper's tile plan, surplus tiles exiting."""
    order, offsets, tile_end, num_tiles = (
        x.numpy() if isinstance(x, torch.Tensor) else x
        for x in H.tile_plan(torch.from_numpy(local), width,
                             torch.from_numpy(live != 0), tile_rows))
    f_slice, num_slices = H.feature_slices(f, b, smem_bytes=b * 3 * 4 * 2)
    out = np.zeros((width, f, b, 3), np.float32)
    seen = np.zeros(len(local), np.int64)
    for t in range(num_tiles):
        node = int(np.searchsorted(tile_end, t, side="right"))
        if node >= width:
            continue
        first = tile_end[node - 1] if node > 0 else 0
        start = offsets[node] + (t - first) * tile_rows
        rows = order[start:min(start + tile_rows, offsets[node + 1])]
        for s in range(num_slices):
            f0 = s * f_slice
            fs = min(f_slice, f - f0)
            if s == 0:
                seen[rows] += 1
            for r in rows:
                if live[r] == 0:
                    continue
                for fl in range(fs):
                    out[node, f0 + fl, binned[r, f0 + fl]] += (
                        grad[r] * live[r], hess[r] * live[r], live[r])
    return out, seen


@pytest.mark.parametrize("n,f,b,width,tile_rows", [
    (300, 5, 16, 4, 32),      # several tiles per node, 3 feature slices
    (257, 3, 8, 8, 16),       # partial tiles everywhere
    (64, 4, 4, 16, 8),        # many empty nodes
    (100, 1, 2, 1, 1000),     # one tile holds the whole level
])
def test_tile_plan_and_cta_walk(n, f, b, width, tile_rows):
    """The kernel's tiling visits every live row exactly once within its
    own node and no masked (live == 0) row at all, the static grid bound
    covers every tile, and the replayed walk reproduces the plain version
    bitwise on integer stats."""
    binned, grad, hess, live, local = _case(n, f, b, width, seed=3,
                                            integer_stats=True)
    if width > 1:
        local[local == 1] = 0          # leave node 1 empty
    assert (live == 0).any()
    got, seen = _replay_kernel(binned, grad, hess, live, local, width, f, b,
                               tile_rows)
    np.testing.assert_array_equal(seen, (live != 0).astype(np.int64))
    _, offsets, tile_end, num_tiles = H.tile_plan(
        torch.from_numpy(local), width, torch.from_numpy(live != 0),
        tile_rows)
    assert int(tile_end[-1]) <= num_tiles
    assert int(offsets[-1]) == int((live != 0).sum())
    counts = np.bincount(local[live != 0], minlength=width)
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
    want = _port((binned, grad, hess, live, local), width, f, b)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("f,b", [(1, 2), (28, 255), (75, 256), (76, 256),
                                 (300, 64), (1000, 255)])
def test_feature_slices_fit_shared_memory(f, b):
    f_slice, num_slices = H.feature_slices(f, b)
    assert f_slice * b * 3 * 4 <= H.SMEM_BYTES
    assert f_slice * num_slices >= f > f_slice * (num_slices - 1)


def test_rejects_inputs_the_kernel_does_not_take():
    binned, grad, hess, live, local = (torch.from_numpy(x) for x in
                                       _case(50, 3, 16, 2))
    ok = (binned, grad, hess, live, local, 2, 3, 16)
    H.level_histogram(*ok)
    bad = [
        (binned.to(torch.int32),) + ok[1:],           # bins not uint8
        ok[:7] + (257,),                               # more than 256 bins
        ok[:6] + (4,) + ok[7:],                        # wrong feature count
        (binned, grad[:-1]) + ok[2:],                  # wrong length
        (binned, grad.double()) + ok[2:],              # wrong dtype
        (binned.t().contiguous().t(),) + ok[1:],       # not contiguous
        ok[:5] + (0,) + ok[6:],                        # no nodes
    ]
    for args in bad:
        with pytest.raises(ValueError):
            H.level_histogram(*args)

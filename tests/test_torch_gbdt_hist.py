"""The port's level histogram (``hist_cuda.level_histogram`` on the CPU,
which runs its plain version) against the JAX package's: the XLA
``per_feature`` formulation of ``trainer._level_histogram`` and the
Pallas kernel ``pallas_level_histogram`` in interpret mode.

Tolerances: float stats ``rtol=1e-5, atol=1e-4`` (sums taken in another
order), counts exact; integer-valued stats bit for bit (every partial
sum is exact in float32, so order cannot matter). The port sums in fixed
point (``H.fixed_point_exponents``), so its float sums are the same bits
in any row order, and lie within ``4*k*u*sum|x|`` (``u = 2^-24``, ``k``
terms) of the JAX sums, the bound of any float32 order.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there. Here the tile plan and the CTA
walk of ``csrc/level_hist.cu`` are replayed in numpy to pin the
kernel's indexing.
"""

from fractions import Fraction

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
    """numpy replay of level_hist.cu: the channels' exponents from their
    amax, then one CTA per (tile, feature slice) over the wrapper's tile
    plan, surplus tiles exiting, each adding its fixed-point terms into
    private int64 cells and flushing them into the int64 sums, then the
    dequantization ``float32(float64(sum) * 2^-e)``."""
    order, offsets, tile_end, num_tiles = (
        x.numpy() if isinstance(x, torch.Tensor) else x
        for x in H.tile_plan(torch.from_numpy(local), width,
                             torch.from_numpy(live != 0), tile_rows))
    f_slice, num_slices = H.feature_slices(f, b, smem_bytes=b * 3 * 8 * 2,
                                           cell_bytes=8)
    x = np.stack([grad * live, hess * live, live], axis=-1)    # float32
    e = H.fixed_point_exponents(torch.from_numpy(np.abs(x).max(axis=0)),
                                len(local)).numpy()
    terms = np.rint(np.ldexp(x.astype(np.float64), e)).astype(np.int64)
    acc = np.zeros((width, f, b, 3), np.int64)
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
            cells = np.zeros((fs, b, 3), np.int64)     # shared memory
            for r in rows:
                for fl in range(fs):
                    cells[fl, binned[r, f0 + fl]] += terms[r]
            acc[node, f0:f0 + fs] += cells             # the flush
    return np.ldexp(acc.astype(np.float64), -e).astype(np.float32), seen


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


# --- the fixed-point sums -----------------------------------------------------

def _exact_exponent(a, n):
    """The largest e with n * a * 2^e <= 2^62, in exact rationals."""
    if a == 0:
        return 0
    v = n * Fraction(float(a))
    e = 62 - v.numerator.bit_length() + v.denominator.bit_length()
    while v * Fraction(2) ** e > 2 ** 62:
        e -= 1
    while v * Fraction(2) ** (e + 1) <= 2 ** 62:
        e += 1
    return e


_F32_TINY = float(np.finfo(np.float32).smallest_subnormal)
AMAXES = [0.0, _F32_TINY, 3 * _F32_TINY, 2.0 ** -126, 1e-30, 0.5, 1.0,
          float(np.nextafter(np.float32(1), np.float32(2))),
          float(np.nextafter(np.float32(1), np.float32(0))), 3.0, 8.0,
          1e10, float(np.finfo(np.float32).max)]


@pytest.mark.parametrize("n", [1, 2, 3, 2000, 2 ** 21, 2_000_000,
                               2 ** 29 + 1, 2 ** 35 - 1])
def test_fixed_point_exponent_is_exact_and_cannot_overflow(n):
    """e is the largest with n * amax * 2^e <= 2^62 (0 at amax = 0,
    subnormal amax included), 2^e and 2^-e are exact powers of two, and n
    terms of magnitude amax, each rounded up, still sum below 2^63."""
    amax = torch.tensor(AMAXES, dtype=torch.float32)
    e = H.fixed_point_exponents(amax, n)
    assert e.dtype == torch.int64
    for a, got in zip(amax.tolist(), e.tolist()):
        assert got == _exact_exponent(a, n), (a, n)
        if a:
            worst = n * -(-Fraction(a) * Fraction(2) ** got // 1)
            assert worst < 2 ** 63
    for s in (H.pow2(e), H.pow2(-e)):
        man, _ = torch.frexp(s)
        assert s.dtype == torch.float64 and bool((man == 0.5).all())
    np.testing.assert_array_equal(H.pow2(e).numpy(),
                                  np.ldexp(1.0, e.numpy()))
    np.testing.assert_array_equal(H.pow2(-e).numpy(),
                                  np.ldexp(1.0, -e.numpy()))


@pytest.mark.parametrize("amax", [_F32_TINY, 2.0 ** -126, 0.75, 1.0,
                                  float(np.finfo(np.float32).max) / 2 ** 13])
@pytest.mark.parametrize("n", [1, 7, 4096])
def test_sums_at_the_int64_limit(amax, n):
    """Every row at +amax in one cell, or alternating +-amax: the int64
    sums reach about 2^62 without overflow, and come back as float32 of
    the exact sum."""
    binned = torch.zeros((n, 1), dtype=torch.uint8)
    local = torch.zeros(n, dtype=torch.int32)
    live = torch.ones(n)
    same = torch.full((n,), amax, dtype=torch.float32)
    out = H.level_histogram(binned, same, same, live, local, 1, 1, 2)
    want = np.float32(float(n * Fraction(float(np.float32(amax)))))
    assert out[0, 0, 0, 0].item() == want and out[0, 0, 0, 2].item() == n
    signs = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    out = H.level_histogram(binned, same * signs, same, live, local, 1, 1, 2)
    assert out[0, 0, 0, 0].item() == np.float32(amax) * (n % 2)


@pytest.mark.parametrize("n,f,b,width", SHAPES)
@pytest.mark.parametrize("integer_stats", [False, True])
def test_fixed_point_is_bitwise_invariant_under_row_permutation(
        n, f, b, width, integer_stats):
    arrays = _case(n, f, b, width, seed=11, integer_stats=integer_stats)
    perm = np.random.default_rng(12).permutation(n)
    got = _port(arrays, width, f, b)
    np.testing.assert_array_equal(got, _port([x[perm] for x in arrays],
                                             width, f, b))
    if integer_stats or width > 4:
        return
    # a float32 index_add_ of the same terms is not order-free: the
    # permutation above does move its bits
    binned, grad, hess, live, local = (torch.from_numpy(x) for x in arrays)

    def f32_sum(p):
        idx = H.flat_index(binned[p], local[p], f, b)
        src = (grad * live)[p][:, None].expand(n, f).reshape(-1)
        return torch.zeros(width * f * b).index_add_(0, idx, src)
    assert not torch.equal(f32_sum(torch.arange(n)),
                           f32_sum(torch.from_numpy(perm)))


def _integer_weighted_case(n, f, b, width, seed):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.integers(-1024, 1025, size=n).astype(np.float32)
    hess = rng.integers(0, 257, size=n).astype(np.float32)
    live = rng.choice(np.array([0, 0.5, 1, 2], np.float32), size=n)
    local = rng.integers(0, width, size=n).astype(np.int32)
    return binned, grad, hess, live, local


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n,f,b,width", [(4096, 3, 16, 2), (1500, 5, 255, 4),
                                         (300, 2, 7, 1)])
def test_fixed_point_bitwise_on_weighted_integer_stats(ref, n, f, b, width):
    """Integer stats up to 2^10 under weights 0, 1/2, 1, 2: every float32
    partial sum is exact, so the fixed-point sums equal JAX's bit for
    bit."""
    arrays = _integer_weighted_case(n, f, b, width, seed=n)
    np.testing.assert_array_equal(_port(arrays, width, f, b),
                                  _jax(ref, arrays, width, f, b))


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("n,f,b,width", SHAPES)
def test_float_sums_within_any_f32_order_bound(ref, n, f, b, width):
    """Float stats: per cell of k terms, |port - jax| and |port - exact|
    are within 4*k*u*sum|x| (u = 2^-24), the bound of any float32 order."""
    arrays = _case(n, f, b, width, seed=21)
    got = _port(arrays, width, f, b).astype(np.float64)
    want = _jax(ref, arrays, width, f, b).astype(np.float64)
    binned, grad, hess, live, local = arrays
    x = np.stack([grad * live, hess * live, live], -1).astype(np.float64)
    exact = np.zeros((width, f, b, 3))
    absum = np.zeros((width, f, b, 3))
    for j in range(f):
        np.add.at(exact, (local, j, binned[:, j]), x)
        np.add.at(absum, (local, j, binned[:, j]), np.abs(x))
    bound = 4 * got[..., 2:3] * 2.0 ** -24 * absum
    assert (np.abs(got - want) <= bound).all()
    assert (np.abs(got - exact) <= bound).all()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("n,f,b,width,tile_rows", [
    (300, 5, 16, 4, 32),
    (257, 3, 8, 8, 16),
])
def test_cta_walk_int64_cells_on_float_stats(n, f, b, width, tile_rows):
    """The replayed walk over int64 cells gives the plain version's bits
    on float stats too: the order of the CTAs and of the rows cannot
    matter."""
    binned, grad, hess, live, local = _case(n, f, b, width, seed=5)
    got, _ = _replay_kernel(binned, grad, hess, live, local, width, f, b,
                            tile_rows)
    np.testing.assert_array_equal(
        got, _port((binned, grad, hess, live, local), width, f, b))


@pytest.mark.parametrize("f,b", [(1, 2), (28, 255), (37, 255), (38, 255),
                                 (300, 64)])
def test_feature_slices_fit_int64_cells(f, b):
    f_slice, num_slices = H.feature_slices(f, b, cell_bytes=8)
    assert f_slice * b * 3 * 8 <= H.SMEM_BYTES
    assert f_slice * num_slices >= f > f_slice * (num_slices - 1)
    if (f, b) == (28, 255):      # the bench shape: one slice, 171,360 B
        assert (f_slice, num_slices) == (28, 1)

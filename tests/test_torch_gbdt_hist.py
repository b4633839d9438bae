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

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against the same plain versions there. Here the counting
partition both kernels share (``csrc/level_hist_common.cuh``, with each
plane's keep mask) and the CTA walks of ``csrc/level_hist.cu`` and
``csrc/level_hist_quant.cu`` (int32 cells, packed stat words, the int32
window) are replayed in numpy to pin the kernels' indexing; the
quantized replay is held bit for bit to the plain version and to the JAX
``trainer._level_histogram_quant``.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as jax_trainer
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


KERNEL_WARPS = 32         # level_hist.cu: kThreads / 32


def _chunk_pairs(rows, fs, warps=KERNEL_WARPS):
    """The (row, feature) pairs of one staged chunk as level_hist.cu adds
    them: warp w takes rows w, w + warps, ..., lane l < fs feature l."""
    for warp in range(warps):
        for j in range(warp, rows, warps):
            for lane in range(32):
                if lane < fs:
                    yield j, lane


# the rows each plane sums: the float32 plane keeps live != 0, the
# quantized plane live > 0 (the gate of its plain version)
KEEP = {"f32": lambda live: live != 0, "quant": lambda live: live > 0}


def _replay_partition(local, live, width, seg_rows=H.PLAN_SEG_ROWS,
                      plane="f32"):
    """numpy replay of the counting partition both kernels share: every
    warp segment of ``seg_rows`` rows counts its rows per key (the node,
    or width for a row the plane does not keep); an exclusive prefix sum
    of the counts in key-major order gives each (key, segment) its first
    place; then each segment walks its rows in order, 32 at a time, the
    lanes of one key taking consecutive places in lane order. Returns the
    kept rows in their places, and the nodes' offsets (offsets[width]:
    the kept rows)."""
    n = len(local)
    key = np.where(KEEP[plane](live), local, width)
    ns = -(-n // seg_rows)
    counts = np.zeros((width + 1, ns), np.int64)
    for s in range(ns):
        np.add.at(counts[:, s], key[s * seg_rows:(s + 1) * seg_rows], 1)
    flat = counts.ravel()
    start = (np.cumsum(flat) - flat).reshape(width + 1, ns)
    offsets = start[:, 0].copy()
    order = np.full(n, -1, np.int64)
    for s in range(ns):
        nxt = start[:, s].copy()
        end = min(n, (s + 1) * seg_rows)
        for base in range(s * seg_rows, end, 32):
            lanes = list(range(base, min(end, base + 32)))
            for lane, r in enumerate(lanes):
                if key[r] != width:
                    below = sum(key[q] == key[r] for q in lanes[:lane])
                    order[nxt[key[r]] + below] = r
            for k, c in zip(*np.unique(key[lanes], return_counts=True)):
                nxt[k] += c
    return order[:offsets[width]], offsets


def _cta_slice(cta, grid, f, f_slice):
    """The feature slice of CTA ``cta`` and its share of the grid, as
    both kernels split a persistent grid in proportion to the slices'
    features: (slice, first CTA, CTA past the last, first feature,
    features)."""
    num_slices = -(-f // f_slice)
    s = 0
    while s + 1 < num_slices and grid * (s + 1) * f_slice // f <= cta:
        s += 1
    g0 = grid * s * f_slice // f
    g1 = grid * (s + 1) * f_slice // f if s + 1 < num_slices else grid
    return s, g0, g1, s * f_slice, min(f_slice, f - s * f_slice)


def _replay_kernel(binned, grad, hess, live, local, width, f, b, chunk,
                   grid, f_slice):
    """numpy replay of level_hist.cu: the channels' exponents from their
    amax; the rows sorted by node (the partition, ``_replay_partition``,
    in 64-row segments); a persistent grid of
    ``grid`` CTAs shared among the feature slices in proportion to their
    features, each CTA walking an equal run of the sorted kept rows node
    by node in chunks of ``chunk`` rows (every (row, feature) pair of a
    chunk in the kernel's warp and lane order), adding the rows' fixed-point
    terms into private int64 cells and flushing them into the int64 sums
    where the run leaves a node; then the dequantization ``float32(
    float64(sum) * 2^-e)``. Returns the histogram, each row's visits per
    slice, and the number of flushes."""
    order, offsets = _replay_partition(local, live, width, seg_rows=64)
    num_slices = -(-f // f_slice)
    x = np.stack([grad * live, hess * live, live], axis=-1)    # float32
    e = H.fixed_point_exponents(torch.from_numpy(np.abs(x).max(axis=0)),
                                len(local)).numpy()
    terms = np.rint(np.ldexp(x.astype(np.float64), e)).astype(np.int64)
    acc = np.zeros((width, f, b, 3), np.int64)
    seen = np.zeros((num_slices, len(local)), np.int64)
    kept, flushes = int(offsets[width]), 0
    for cta in range(grid):
        s, g0, g1, f0, fs = _cta_slice(cta, grid, f, f_slice)
        p = kept * (cta - g0) // (g1 - g0)
        p_end = kept * (cta - g0 + 1) // (g1 - g0)
        w = int(np.searchsorted(offsets[:width], p, side="right")) - 1
        cells = np.zeros((fs, b, 3), np.int64)            # shared memory
        while p < p_end:
            seg_end = min(p_end, int(offsets[w + 1]))
            if seg_end > p:
                for c0 in range(p, seg_end, chunk):
                    rows = order[c0:min(c0 + chunk, seg_end)]
                    seen[s, rows] += 1
                    for j, fl in _chunk_pairs(len(rows), fs):
                        r = rows[j]
                        cells[fl, binned[r, f0 + fl]] += terms[r]
                acc[w, f0:f0 + fs] += cells                # the flush
                cells[:] = 0
                flushes += 1
                p = seg_end
            w += 1
    out = np.ldexp(acc.astype(np.float64), -e).astype(np.float32)
    return out, seen, flushes


def _pack(gq, hq):
    """The quantized partition's packed word per row: grad_q in the low
    half, hess_q in the high half, each as int16 (int8 widened)."""
    lo = gq.astype(np.int16).view(np.uint16).astype(np.uint32)
    hi = hq.astype(np.int16).view(np.uint16).astype(np.uint32)
    return lo | hi << np.uint32(16)


def _unpack(words):
    """The packed word's halves sign-extended to int32, as the kernel's
    ``low_half`` / ``high_half`` do."""
    return ((words << np.uint32(16)).view(np.int32) >> 16,
            words.view(np.int32) >> 16)


def _replay_quant_kernel(binned, gq, hq, live, local, width, f, b, gsi,
                         hsi, chunk, grid, f_slice, window):
    """numpy replay of level_hist_quant.cu: the rows with live > 0 sorted
    by node (``_replay_partition`` in 64-row segments) and their packed
    words; a persistent grid of ``grid`` CTAs shared among the feature
    slices, each CTA staging an equal run of the sorted kept rows in
    chunks of ``chunk`` positions, adding each chunk node by node into
    int32 cells (wrapping as the card's do) in three channel planes over
    (bin, lane), and flushing them, sign-extended, into the int64 sums
    where the run leaves a node or once one more chunk could pass
    ``window`` rows; then ``float32(sum * float64(scale_inv))``. Returns
    the histogram, each row's visits per slice, the number of flushes and
    the largest magnitude a cell held between flushes."""
    order, offsets = _replay_partition(local, live, width, seg_rows=64,
                                       plane="quant")
    gw, hw = _unpack(_pack(gq, hq))
    num_slices = -(-f // f_slice)
    acc = np.zeros((width, f, b, 3), np.int64)
    seen = np.zeros((num_slices, len(local)), np.int64)
    kept, flushes, most = int(offsets[width]), 0, 0
    for cta in range(grid):
        s, g0, g1, f0, fs = _cta_slice(cta, grid, f, f_slice)
        p = kept * (cta - g0) // (g1 - g0)
        p_end = kept * (cta - g0 + 1) // (g1 - g0)
        w = int(np.searchsorted(offsets[:width], p, side="right")) - 1
        cells = np.zeros((3, b, 32), np.int32)             # shared memory
        exact = np.zeros((3, b, 32), np.int64)             # the same, unwrapped
        since = 0
        for c0 in range(p, p_end, chunk):
            c1 = min(c0 + chunk, p_end)
            pos = c0
            while pos < c1:                                # node by node
                while offsets[w + 1] <= pos:
                    w += 1
                node_end = int(offsets[w + 1])
                seg_end = min(c1, node_end)
                rows = order[pos:seg_end]
                seen[s, rows] += 1
                ones = np.ones(len(rows), np.int32)
                for lane in range(fs):
                    bins = binned[rows, f0 + lane]
                    for c, v in enumerate((gw[rows], hw[rows], ones)):
                        np.add.at(cells[c, :, lane], bins, v)
                        np.add.at(exact[c, :, lane], bins, v)
                since += seg_end - pos
                pos = seg_end
                if pos == node_end or pos == p_end or since > window - chunk:
                    most = max(most, int(np.abs(exact).max()))
                    acc[w, f0:f0 + fs] += cells[:, :, :fs].transpose(2, 1, 0)
                    cells[:] = 0
                    exact[:] = 0
                    flushes += 1
                    since = 0
    scales = np.array([np.float32(gsi), np.float32(hsi), 1.0], np.float64)
    return (acc * scales).astype(np.float32), seen, flushes, most


@pytest.mark.parametrize("rows,fs", [(256, 32), (256, 28), (7, 28),
                                     (256, 5), (33, 12), (1, 1)])
def test_chunk_pairs_cover_each_row_and_feature_once(rows, fs):
    pairs = list(_chunk_pairs(rows, fs))
    assert sorted(pairs) == [(j, fl) for j in range(rows) for fl in range(fs)]


@pytest.mark.parametrize("n,f,b,width,chunk,grid,f_slice", [
    (300, 5, 16, 4, 32, 6, 4),    # several chunks per node, 2 slices
    (257, 3, 8, 8, 16, 5, 1),     # partial chunks everywhere, 3 slices
    (64, 4, 4, 16, 8, 3, 4),      # many empty nodes, one slice
    (100, 1, 2, 1, 1000, 1, 1),   # one CTA, one chunk holds the level
    (50, 7, 8, 4, 4, 64, 4),      # more CTAs than kept rows
])
def test_tile_plan_and_cta_walk(n, f, b, width, chunk, grid, f_slice):
    """Each kernel's walk visits every row it keeps exactly once per
    feature slice and no other row at all, flushes at most once per CTA
    and node it reaches, and the replayed walk reproduces its plain
    version bitwise on integer stats: the float32 kernel's over int64
    cells, the quantized kernel's over int32 cells and packed words."""
    binned, grad, hess, live, local = _case(n, f, b, width, seed=3,
                                            integer_stats=True)
    if width > 1:
        local[local == 1] = 0          # leave node 1 empty
    assert (live == 0).any()
    got, seen, flushes = _replay_kernel(binned, grad, hess, live, local,
                                        width, f, b, chunk, grid, f_slice)
    for per_slice in seen:
        np.testing.assert_array_equal(per_slice, (live != 0).astype(np.int64))
    assert flushes <= grid + width * -(-f // f_slice)
    want = _port((binned, grad, hess, live, local), width, f, b)
    np.testing.assert_array_equal(got, want)
    gq, hq = grad.astype(np.int16), hess.astype(np.int16)
    got, seen, flushes, _ = _replay_quant_kernel(
        binned, gq, hq, live, local, width, f, b, 2.0 ** -3, 2.0 ** -5,
        chunk, grid, f_slice, H.quant_window(16))
    for per_slice in seen:
        np.testing.assert_array_equal(per_slice, (live > 0).astype(np.int64))
    assert flushes <= grid + width * -(-f // f_slice)
    np.testing.assert_array_equal(got, H.level_histogram_quant(
        *(torch.from_numpy(x) for x in (binned, gq, hq, live, local)),
        width, f, b, 2.0 ** -3, 2.0 ** -5).numpy())


def _add64(lo, hi, t):
    """level_hist.cu's add64 on numpy uint32 words: the low word's add
    returns the old value, whose carry joins the term's high half."""
    tl = np.uint32(int(t) & 0xFFFFFFFF)
    old = lo[0]
    lo[0] = old + tl
    th = np.uint32((int(t) >> 32) & 0xFFFFFFFF) + np.uint32(lo[0] < old)
    hi[0] = hi[0] + th


@pytest.mark.parametrize("seed", range(4))
def test_split_word_adds_give_the_int64_sum(seed):
    """Terms of either sign up to 2^62 / n, added in any order as two
    32-bit words with a carry, leave the words of the exact int64 sum."""
    rng = np.random.default_rng(seed)
    n = 3000
    limit = 2 ** 62 // n
    terms = [int(x) for x in rng.integers(-limit, limit, n)]
    terms[:3] = [limit, -limit, 0]
    for order in (range(n), rng.permutation(n)):
        lo, hi = np.zeros(1, np.uint32), np.zeros(1, np.uint32)
        with np.errstate(over="ignore"):
            for i in order:
                _add64(lo, hi, terms[i])
        got = (int(hi[0]) << 32 | int(lo[0]))
        got -= (got >> 63) << 64                       # two's complement
        assert got == sum(terms)


def _int64_sort_plan(local, width, keep):
    """Rows sorted by an int64 node key, kept rows first (stable): the
    order and offsets the partition must give."""
    key = torch.where(keep, local.long(), width)
    sorted_key, order = torch.sort(key, stable=True)
    return order, torch.searchsorted(
        sorted_key, torch.arange(width + 1, dtype=torch.int64))


@pytest.mark.parametrize("width", [1, 2, 3, 4, 7, 8, 16, 31, 32])
@pytest.mark.parametrize("plane", ["f32", "quant"])
def test_partition_keep_mask_equals_int64_sort(width, plane):
    """The shared partition (replayed) under each plane's keep mask (live
    != 0, or live > 0 on the quantized plane: live = -1 is dropped there
    and kept on the float32 plane) puts the kept rows in the int64 stable
    sort's order, with its offsets, bit for bit: dead rows, empty nodes,
    every width of a depth-6 tree."""
    rng = np.random.default_rng(width)
    n = 3000
    local = rng.integers(0, width, n).astype(np.int32)
    if width > 2:
        local[local == width - 2] = 0                  # an empty node
    live = rng.choice(np.array([0.0, -1.0, 0.5, 1.0], np.float32), n)
    keep = KEEP[plane](live)
    order, offsets = _replay_partition(local, live, width, 64, plane)
    want_order, want_offsets = _int64_sort_plan(
        torch.from_numpy(local), width, torch.from_numpy(keep))
    kept = int(want_offsets[width])
    assert kept == int(keep.sum()) < n
    np.testing.assert_array_equal(order, want_order.numpy()[:kept])
    np.testing.assert_array_equal(offsets, want_offsets.numpy())


@pytest.mark.parametrize("width", [1, 2, 3, 8, 16, 32, 100])
@pytest.mark.parametrize("seg_rows", [32, 64, 2048])
def test_counting_partition_equals_int64_sort(width, seg_rows):
    """level_hist.cu's counting partition (replayed) puts the kept rows
    in the int64 stable sort's order, with its offsets, bit for bit: dead
    rows, empty nodes, ragged last segments."""
    rng = np.random.default_rng(width + seg_rows)
    n = 1000
    local = rng.integers(0, width, n).astype(np.int32)
    if width > 2:
        local[local == width - 2] = 0                  # an empty node
    live = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), n)
    order, offsets = _replay_partition(local, live, width, seg_rows)
    want_order, want_offsets = _int64_sort_plan(
        torch.from_numpy(local), width, torch.from_numpy(live != 0))
    kept = int(want_offsets[width])
    np.testing.assert_array_equal(order, want_order.numpy()[:kept])
    np.testing.assert_array_equal(offsets, want_offsets.numpy())


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


@pytest.mark.parametrize("plane", ["f32", "quant"])
@pytest.mark.parametrize("width,n", [(H.MAX_WIDTH + 1, 50), (2, 2 ** 31)])
def test_both_planes_refuse_what_the_partition_cannot_hold(plane, width, n):
    """On the card both kernels partition the rows with per-warp key
    counters and int32 places: wider levels, or 2^31 rows, raise the same
    error before anything is built or launched."""
    binned, grad, hess, live, local = (torch.from_numpy(x) for x in
                                       _case(50, 3, 16, 2))
    if n > 50:                         # a view: no 2^31-row allocation
        binned = binned[:1].expand(n, 3)
    launch = H._launch if plane == "f32" else H._launch_quant
    stats = (grad, hess) if plane == "f32" else \
        (grad.to(torch.int16), hess.to(torch.int16), 1.0, 1.0)
    with pytest.raises(ValueError, match="the level-histogram kernels take "
                                         f"width <= {H.MAX_WIDTH}"):
        launch(binned, *stats[:2], live, local, width, 3, 16, *stats[2:])


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


@pytest.mark.parametrize("n,f,b,width,chunk,grid,f_slice", [
    (300, 5, 16, 4, 32, 6, 4),
    (257, 3, 8, 8, 16, 5, 1),
])
def test_cta_walk_int64_cells_on_float_stats(n, f, b, width, chunk, grid,
                                             f_slice):
    """The replayed walk over int64 cells gives the plain version's bits
    on float stats too: the order of the CTAs and of the rows cannot
    matter."""
    binned, grad, hess, live, local = _case(n, f, b, width, seed=5)
    got, _, _ = _replay_kernel(binned, grad, hess, live, local, width, f, b,
                               chunk, grid, f_slice)
    np.testing.assert_array_equal(
        got, _port((binned, grad, hess, live, local), width, f, b))


@pytest.mark.parametrize("f,b", [(1, 2), (28, 255), (37, 255), (38, 255),
                                 (300, 64), (7, 256), (1000, 2), (32, 256),
                                 (32, 255)])
def test_feature_slices_fit_int64_cells(f, b):
    """``level_hist.cu``'s slices: the fewest of at most 32 features (a
    lane each) whose int64 cells over 32 lanes plus the staged chunks fit
    one CTA's shared memory, as even as possible, multiples of 4 when F
    is, covering F."""
    f_slice, num_slices = H.f32_feature_slices(f, b)
    smem = H.f32_smem_bytes(f_slice, b)
    assert 6 * b * 32 * 4 < smem <= H.SMEM_BYTES
    assert f_slice <= 32
    assert f_slice * num_slices >= f > f_slice * (num_slices - 1)
    if num_slices > 1:                      # the fewest slices that fit
        wider = -(-f // (num_slices - 1))
        assert wider > 32 or H.f32_smem_bytes(wider, b) > H.SMEM_BYTES
    if f % 4 == 0:
        assert f_slice % 4 == 0
    if (f, b) == (28, 255):      # the bench shape: one slice
        assert (f_slice, num_slices) == (28, 1)


# --- the quantized kernel's walk ---------------------------------------------

QBITS = {"q16": 16, "q8": 8}


def _extreme_quant_case(n, f, b, width, quant, seed):
    """int16/int8 stats over the whole range, the extremes -2^(bits-1)
    and 2^(bits-1) - 1 included; live in {0, -1, 0.5, 1} (the quantized
    plane sums live > 0 with weight 1)."""
    rng = np.random.default_rng(seed)
    dtype = np.int16 if quant == "q16" else np.int8
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    gq = rng.integers(lo, hi + 1, size=n).astype(dtype)
    hq = rng.integers(lo, hi + 1, size=n).astype(dtype)
    gq[:4], hq[:4] = [lo, hi, lo, hi], [hi, lo, lo, hi]
    live = rng.choice(np.array([0.0, -1.0, 0.5, 1.0], np.float32), n)
    live[:4] = 1.0
    local = rng.integers(0, width, size=n).astype(np.int32)
    if width > 2:
        local[local == 1] = 0                          # an empty node
    return binned, gq, hq, live, local


@pytest.mark.parametrize("quant", ["q16", "q8"])
@pytest.mark.parametrize("n,f,b,width,chunk,grid,f_slice", [
    (3000, 28, 255, 1, 256, 3, 28),   # the bench's slice at the root
    (2000, 7, 32, 4, 64, 5, 4),       # two slices, runs across nodes
    (999, 3, 64, 32, 16, 7, 1),       # three slices, many small nodes
    (64, 5, 8, 16, 8, 40, 5),         # more CTAs than kept rows
])
def test_quant_cta_walk_is_bitwise(quant, n, f, b, width, chunk, grid,
                                   f_slice):
    """The replayed quantized walk (int32 cells, packed words, sign
    extension, slices, runs, flushes) equals the plain version and the
    JAX ``_level_histogram_quant`` bit for bit, with stats at +-qmax."""
    binned, gq, hq, live, local = _extreme_quant_case(n, f, b, width, quant,
                                                      seed=n + width)
    gsi, hsi = 2.0 ** -13, 2.0 ** -9
    got, seen, _, most = _replay_quant_kernel(
        binned, gq, hq, live, local, width, f, b, gsi, hsi, chunk, grid,
        f_slice, H.quant_window(QBITS[quant]))
    for per_slice in seen:
        np.testing.assert_array_equal(per_slice, (live > 0).astype(np.int64))
    assert most < 2 ** 31
    plain = H.level_histogram_quant(
        *(torch.from_numpy(x) for x in (binned, gq, hq, live, local)),
        width, f, b, gsi, hsi).numpy()
    xla = np.asarray(jax_trainer._level_histogram_quant(
        *(jnp.asarray(x) for x in (binned, gq, hq, live, local)), width, f,
        b, jnp.float32(gsi), jnp.float32(hsi), formulation="per_feature"))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_quant_window_holds_int32_cells(quant):
    """W rows of the largest magnitude fit an int32 cell, W + 1 need not:
    W * 2^(bits-1) < 2^31 <= (W + 1) * 2^(bits-1)."""
    bits = QBITS[quant]
    w = H.quant_window(bits)
    assert w == {"q16": 65_535, "q8": 16_777_215}[quant]
    assert w * 2 ** (bits - 1) < 2 ** 31 <= (w + 1) * 2 ** (bits - 1)
    assert w >= H.QUANT_CHUNK_ROWS


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_quant_window_flushes_mid_node(quant):
    """With a window of a few chunks a CTA flushes inside a node's run,
    several times per node, and the sums keep the plain version's bits;
    no cell ever held more than window rows' worth."""
    n, f, b, width, chunk, grid = 2500, 3, 16, 2, 16, 2
    binned, gq, hq, live, local = _extreme_quant_case(n, f, b, width, quant,
                                                      seed=7)
    window = 3 * chunk
    got, _, flushes, most = _replay_quant_kernel(
        binned, gq, hq, live, local, width, f, b, 1.0, 1.0, chunk, grid, f,
        window)
    kept = int((live > 0).sum())
    assert flushes >= kept // window > grid + width
    assert most <= window * 2 ** (QBITS[quant] - 1)
    np.testing.assert_array_equal(got, H.level_histogram_quant(
        *(torch.from_numpy(x) for x in (binned, gq, hq, live, local)),
        width, f, b, 1.0, 1.0).numpy())


def test_quant_window_stops_int32_wrap():
    """70,000 rows of one node at +32767 in one CTA: the q16 window
    flushes the int32 cells before they wrap, and the replay gives the
    plain version's bits; without the window the cells wrap and the sums
    are wrong."""
    n, b = 70_000, 2
    binned = np.zeros((n, 1), np.uint8)
    top = np.full(n, 32767, np.int16)
    live = np.ones(n, np.float32)
    local = np.zeros(n, np.int32)
    want = H.level_histogram_quant(
        *(torch.from_numpy(x) for x in (binned, top, top, live, local)),
        1, 1, b, 1.0, 1.0).numpy()
    assert want[0, 0, 0, 0] == np.float32(32767 * n) and n > H.quant_window(16)
    for window, exact in ((H.quant_window(16), True), (2 ** 62, False)):
        got, _, flushes, most = _replay_quant_kernel(
            binned, top, top, live, local, 1, 1, b, 1.0, 1.0,
            H.QUANT_CHUNK_ROWS, 1, 1, window)
        assert np.array_equal(got, want) is exact
        assert (most < 2 ** 31) is exact
        assert flushes == (2 if exact else 1)


@pytest.mark.parametrize("f,b", [(1, 2), (28, 255), (33, 255), (75, 256),
                                 (300, 64)])
def test_quant_feature_slices_fit_shared_memory(f, b):
    """``level_hist_quant.cu``'s slices: at most 32 features (a lane
    each), the fewest slices, as even as possible, multiples of 4 where F
    is, covering F; the CTA's int32 cells and staging ring fit its shared
    memory."""
    f_slice, num_slices = H.quant_feature_slices(f, b)
    smem = H.quant_smem_bytes(f_slice, b)
    assert 3 * b * 32 * 4 < smem <= H.SMEM_BYTES
    assert f_slice <= 32 and num_slices == -(-f // 32)
    assert f_slice * num_slices >= f > f_slice * (num_slices - 1)
    if f % 4 == 0:
        assert f_slice % 4 == 0
    if (f, b) == (28, 255):      # the bench shape: one slice
        assert (f_slice, num_slices) == (28, 1)

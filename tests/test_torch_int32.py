"""int32 bin ids in the port (``max_bin`` past 65,536) against the JAX
package, on the CPU: the plain int32 histograms (the float32 plane, q16
and q8, the chunk-merged sums), ``train`` depthwise, leaf-wise, under
DART, with EFB and streamed out of core, ``LightGBMClassifier`` at
``maxBin=70000``, and binned scoring of boosters whose thresholds pass
65,534 or whose split features pass 32,767 (the scorer's wide nodes).

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off unless a test turns them on.
Tolerances, by case:

  - histograms: bit for bit on integer-valued stats (every sum exact in
    float32, C4) and on quantized stats;
  - fits on q8, and on the float32 plane with a custom objective whose
    gradients are multiples of 1/8 (exact sums): every booster array bit
    for bit, evals within ``rtol=1e-6``;
  - the float32 plane on float data: split features, bins and counts
    exact, node values within ``rtol=1e-5`` (the reference sums bins in
    float32 in its own order, the port's sums are exact-rounded);
  - binned scoring: bit for bit against ``predict_binned_jit()``, on the
    wide tables' plain version and through ``TreeScorer``; a replay of
    the kernel's loops on wide tables gives the plain version's bits.

The kernels run on the card only: ``chip_smoke.py``'s phases
``kernel_i32``, ``int32_path`` and ``kernel_score`` hold them to these
plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu.ops import efb as jax_efb
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.models.gbdt import (
    estimators,
    hist_cuda,
    score_cuda,
    trainer,
)
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.ops import efb
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_tree_score import _replay

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
B = 70_000                       # max_bin of every case: int32 ids


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv(efb.EFB, "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV,
                 trainer.GROW_POLICY_ENV, "MMLSPARK_TORCH_OOC"):
        monkeypatch.delenv(name, raising=False)
    env.reset_warnings()
    yield
    env.reset_warnings()


def _knobs(monkeypatch, quant="q8", sub="0", bundling="off"):
    """The same histogram plane, subtraction and EFB policy on both
    sides."""
    for jax_name, port_name, v in (
            ("MMLSPARK_TPU_HIST_QUANT", trainer.HIST_QUANT_ENV, quant),
            ("MMLSPARK_TPU_HIST_SUB", trainer.HIST_SUB_ENV, sub),
            ("MMLSPARK_TPU_EFB", efb.EFB, bundling)):
        monkeypatch.setenv(jax_name, v)
        monkeypatch.setenv(port_name, v)


def _data(n=2000, f=4, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (1.5 * x[:, 0] - x[:, 1] + 0.5 * np.sin(3 * x[:, 2])
         + rng.normal(size=n) * 0.6)
    return x, y, (y > 0).astype(np.float64)


def _binned(x, max_bin=B):
    """int32 bin ids (``max_bin`` past 65,536) and the bins' upper
    values."""
    m = BinMapper.fit(x, max_bin=max_bin)
    return m.transform(x), m.bin_upper_values(max_bin)


def _fit_both(binned, y, bin_upper, fobj=None, **cfg):
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper, custom_objective=fobj)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, custom_objective=fobj,
                       device="cpu")
    return jr, pr


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.init_score == want.init_score


def _assert_evals_match(got, want, rtol=1e-6):
    assert [list(e) for e in got] == [list(e) for e in want]
    for pe, je in zip(got, want):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=rtol)


def dyadic_objective(preds, labels, weights):
    """L2 gradients rounded to multiples of 1/8, hessians 1: every
    histogram sum is exact in float32, so both packages sum to the same
    bits on the float32 plane."""
    p = np.asarray(preds, np.float64)
    g = np.round((p - np.asarray(labels, np.float64)) * 8.0) / 8.0
    return g.astype(np.float32), np.ones(p.shape, np.float32)


def _xla_sigmoid(monkeypatch):
    monkeypatch.setattr(torch, "sigmoid", lambda t: torch.from_numpy(
        np.array(jax.nn.sigmoid(t.numpy()))))


# --- the plain histograms on int32 ids ---------------------------------------

def _hist_case(n, f, b, width, seed):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.int32)
    binned[:4] = b - 1                             # the top bin is used
    grad = rng.integers(-8, 9, size=n).astype(np.float32)
    hess = rng.integers(1, 9, size=n).astype(np.float32)
    live = (rng.random(n) < 0.9).astype(np.float32)
    local = rng.integers(0, width, size=n).astype(np.int32)
    return binned, grad, hess, live, local


@pytest.mark.parametrize("plane", ["f32", "q16", "q8"])
def test_plain_histograms_on_int32_ids_are_jax_bitwise(plane):
    n, f, width = 3000, 4, 8
    binned, grad, hess, live, local = _hist_case(n, f, B, width, seed=5)
    if plane == "f32":
        arrays = (binned, grad, hess, live, local)
        got = hist_cuda.level_histogram(
            *(torch.from_numpy(a) for a in arrays), width, f, B)
        want = jax_trainer._level_histogram(
            *(jnp.asarray(a) for a in arrays), width, f, B)
    else:
        dtype = np.int16 if plane == "q16" else np.int8
        lim = np.iinfo(dtype)
        rng = np.random.default_rng(6)
        gq = rng.integers(lim.min, lim.max + 1, size=n).astype(dtype)
        hq = rng.integers(lim.min, lim.max + 1, size=n).astype(dtype)
        arrays = (binned, gq, hq, live, local)
        got = hist_cuda.level_histogram_quant(
            *(torch.from_numpy(a) for a in arrays), width, f, B,
            2.0 ** -11, 2.0 ** -7)
        want = jax_trainer._level_histogram_quant(
            *(jnp.asarray(a) for a in arrays), width, f, B,
            jnp.float32(2.0 ** -11), jnp.float32(2.0 ** -7),
            formulation="per_feature")
    assert got.shape == (width, f, B, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_and_uint16_ids_give_the_same_sums():
    """The same ids below 65,536 as uint16 and as int32: the same
    histogram, on both planes."""
    n, f, b, width = 2000, 3, 65_536, 4
    binned, grad, hess, live, local = (torch.from_numpy(a) for a in
                                       _hist_case(n, f, b, width, seed=7))
    u16 = binned.to(torch.int16).view(torch.uint16)
    args = (grad, hess, live, local, width, f, b)
    np.testing.assert_array_equal(
        hist_cuda.level_histogram(binned, *args).numpy(),
        hist_cuda.level_histogram(u16, *args).numpy())
    q = grad.to(torch.int16), hess.to(torch.int16)
    qargs = (*q, live, local, width, f, b, 0.5, 0.25)
    np.testing.assert_array_equal(
        hist_cuda.level_histogram_quant(binned, *qargs).numpy(),
        hist_cuda.level_histogram_quant(u16, *qargs).numpy())


def test_chunk_merged_sums_on_int32_ids_are_the_one_pass():
    """Chunks of int32 rows added into one int64 accumulator and
    dequantized once: the one-pass quantized histogram bit for bit, and
    the reference's."""
    n, f, width = 3000, 4, 4
    binned, _, _, live, local = _hist_case(n, f, B, width, seed=8)
    rng = np.random.default_rng(9)
    gq = rng.integers(-127, 128, size=n).astype(np.int8)
    hq = rng.integers(0, 128, size=n).astype(np.int8)
    t = [torch.from_numpy(a) for a in (binned, gq, hq, live, local)]
    acc = torch.zeros((width, f, B, 3), dtype=torch.int64)
    for s in range(0, n, 700):
        hist_cuda.level_histogram_quant_sums(
            *(a[s:s + 700] for a in t), width, f, B, acc)
    merged = hist_cuda.dequantize_sums(acc, 2.0 ** -6, 2.0 ** -5)
    one = hist_cuda.level_histogram_quant(*t, width, f, B, 2.0 ** -6,
                                          2.0 ** -5)
    want = jax_trainer._level_histogram_quant(
        *(jnp.asarray(a) for a in (binned, gq, hq, live, local)), width, f,
        B, jnp.float32(2.0 ** -6), jnp.float32(2.0 ** -5),
        formulation="per_feature")
    np.testing.assert_array_equal(merged.numpy(), one.numpy())
    np.testing.assert_array_equal(merged.numpy(), np.asarray(want))


def test_int32_ids_reach_the_device_as_int32():
    """``max_bin`` past 65,536 uploads int32 ids, from numpy or from any
    tensor of ids; ids outside [0, max_bin) raise."""
    ids = np.array([[0, 69_999], [65_536, 3]], np.int64)
    for src in (ids, ids.astype(np.int32), torch.from_numpy(ids),
                torch.from_numpy(ids.astype(np.int32))):
        got = trainer._binned_to_device(src, B, torch.device("cpu"))
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), ids)
    wraps = ids.copy()
    wraps[0, 0] = 2 ** 32 + 3          # 3 once narrowed to int32
    for bad in (ids - 1, ids + 1, wraps, torch.from_numpy(wraps)):
        with pytest.raises(ValueError, match="max_bin"):
            trainer._binned_to_device(bad, B, torch.device("cpu"))


# --- the kernels' int32 walk, replayed ----------------------------------------
#
# ``csrc/level_hist_common.cuh``'s int32 histogram on numpy: the
# partition (kept rows in node order), the gather into node-ordered
# columns with their tile keys, items (node, feature, tile) taken in
# counter order, each warp's steps of key words, each lane's matched places
# in bit order with a run of one cell merged in registers, the split-word
# adds into shared cells, the last runs' warp-wide merge, and the
# epilogue that writes each cell once (dequantized, or added into the
# caller's sums where nonzero) and clears it.

def _keep_and_terms(plane, grad, hess, live):
    """Which rows the plane keeps, and each row's three int64 terms: on
    the float32 plane ``round(x * 2^e_c)`` of (grad*live, hess*live,
    live) under the fixed-point exponents of all the rows (the count
    pass's amax), on the quantized planes (grad_q, hess_q, 1); and the
    dequantization's scales."""
    if plane == "f32":
        data = np.stack([grad * live, hess * live, live], -1)
        e = hist_cuda.fixed_point_exponents(
            torch.from_numpy(np.abs(data).max(0) if len(data)
                             else np.zeros(3, np.float32)), len(data))
        terms = np.round(data.astype(np.float64)
                         * hist_cuda.pow2(e).numpy()).astype(np.int64)
        return live != 0, terms, hist_cuda.pow2(-e).numpy()
    terms = np.stack([grad.astype(np.int64), hess.astype(np.int64),
                      np.ones(len(grad), np.int64)], -1)
    return live > 0, terms, None


def _add_cell(lo, hi, bin_, sums):
    """``add_cell``: per channel the low word's add returns its old value,
    whose carry joins the high word with the term's high half."""
    for c, t in enumerate(sums):
        t = int(t)
        tl = t & 0xFFFFFFFF
        old = int(lo[c, bin_])
        lo[c, bin_] = (old + tl) & 0xFFFFFFFF
        th = ((t >> 32) + (1 if old + tl > 0xFFFFFFFF else 0)) & 0xFFFFFFFF
        hi[c, bin_] = (int(hi[c, bin_]) + th) & 0xFFFFFFFF


def _take_cells(lo, hi, bt):
    """The tile's first ``bt`` cells as int64 sums, (bt, 3), cleared."""
    v = (hi[:, :bt].astype(np.uint64) << np.uint64(32)) | lo[:, :bt]
    lo[:] = 0
    hi[:] = 0
    return v.view(np.int64).T.copy()


def _replay_i32(binned, grad, hess, live, local, width, f, b, plane,
                tile_bins, num_tiles, scales=None, acc=None):
    """The int32 walk replayed: the (width, F, B, 3) float32 histogram
    (scales: the quantized planes' (gscale_inv, hscale_inv)), or with
    ``acc`` the chunk-merge entry adding into it; and per kept (place,
    feature) pair the times an item added it."""
    n = len(binned)
    keep, terms, inv = _keep_and_terms(plane, grad, hess, live)
    if scales is not None:
        inv = np.array([np.float32(scales[0]), np.float32(scales[1]), 1.0])
    # the partition: kept rows stably in node order
    key = np.where(keep & (local >= 0) & (local < width), local, width)
    order = np.argsort(key, kind="stable")
    offsets = np.searchsorted(key[order], np.arange(width + 1))
    order = order[:offsets[width]]
    # the gather: node-ordered columns, their tile keys and the stats
    cols = binned[order].T.astype(np.int64)
    keys = ((cols & 0xFFFFFFFF) // tile_bins & 255).astype(np.uint8)
    nterms = terms[order]
    warps, words = hist_cuda.I32_THREADS // 32, hist_cuda.I32_WORDS
    step = 32 * words
    out = None if acc is not None else np.zeros((width, f, b, 3), np.float32)
    seen = np.zeros((len(order), f), np.int64)
    lo = np.zeros((3, tile_bins), np.uint32)
    hi = np.zeros((3, tile_bins), np.uint32)
    for v in range(width * f * num_tiles):
        t, wf = v % num_tiles, v // num_tiles
        w, fl = wf // f, wf % f
        t0 = t * tile_bins
        bt = min(tile_bins, b - t0)
        p0, p1 = int(offsets[w]), int(offsets[w + 1])
        q0, q1 = p0 >> 2, (p1 + 3) >> 2
        cur = np.full(warps * 32, -1)
        run = np.zeros((warps * 32, 3), np.int64)
        for warp in range(warps):
            for qb in range(q0 + warp * step, q1, warps * step):
                for lane in range(32):
                    i = warp * 32 + lane
                    places = [4 * q + j
                              for q in range(qb + lane, qb + step, 32)
                              if q < q1 for j in range(4)
                              if p0 <= 4 * q + j < p1
                              and keys[fl, 4 * q + j] == t & 255]
                    for p in places:
                        bin_ = (int(cols[fl, p]) - t0) & 0xFFFFFFFF
                        if bin_ >= bt:
                            continue
                        seen[p, fl] += 1
                        if bin_ != cur[i]:
                            if cur[i] >= 0:
                                _add_cell(lo, hi, cur[i], run[i])
                            cur[i], run[i] = bin_, 0
                        run[i] += nterms[p]
            lanes = slice(warp * 32, warp * 32 + 32)
            if (cur[lanes] == cur[warp * 32]).all():
                if cur[warp * 32] >= 0:
                    _add_cell(lo, hi, cur[warp * 32], run[lanes].sum(0))
            else:
                for i in range(warp * 32, warp * 32 + 32):
                    if cur[i] >= 0:
                        _add_cell(lo, hi, cur[i], run[i])
        sums = _take_cells(lo, hi, bt)
        if acc is None:
            out[w, fl, t0:t0 + bt] = (sums.astype(np.float64)
                                      * inv).astype(np.float32)
        else:
            touched = (sums != 0).any(1)
            acc[w, fl, t0:t0 + bt][touched] += sums[touched]
    # every kept pair once, in its own tile's item
    np.testing.assert_array_equal(seen, (cols.T >= 0) & (cols.T < b))
    return out


def _i32_case(n, f, b, width, seed, skew=0.0, member=None):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.int32)
    if skew:
        default = rng.integers(0, b, size=f)
        binned = np.where(rng.random((n, f)) < skew, default, binned
                          ).astype(np.int32)
    binned[:2] = b - 1                             # the top bin is used
    grad = rng.integers(-8, 9, size=n).astype(np.float32)
    hess = rng.integers(1, 9, size=n).astype(np.float32)
    live = (rng.random(n) < 0.9).astype(np.float32)
    if member is not None:                         # one node's membership
        live = (rng.random(n) < member).astype(np.float32)
    local = rng.integers(0, width, size=n).astype(np.int32)
    if width > 2:
        local[local == 1] = 0                      # node 1 is empty
    return binned, grad, hess, live, local


I32_WALKS = {
    # several tiles per feature, the last short (70,000 = 17 x 4,096 + 368)
    "tiles": dict(n=1500, f=3, b=70_000, width=4, tile_bins=4096),
    # the card's plan at 131,072 bins (14 tiles of 9,363), an empty node
    "card_plan": dict(n=2000, f=2, b=131_072, width=8, tile_bins=None),
    # the fewest bins that take int32 ids
    "b65537": dict(n=900, f=2, b=65_537, width=2, tile_bins=None),
    # the leaf-wise builder's width-1 call on 2% of the rows
    "width1_member": dict(n=3000, f=4, b=131_072, width=1, tile_bins=9000,
                          member=0.02),
    # 90% of each feature's rows in one bin
    "skewed": dict(n=2500, f=3, b=100_003, width=4, tile_bins=5000,
                   skew=0.9),
}


def _walk_args(case, seed):
    c = dict(I32_WALKS[case])
    tile_bins = c.pop("tile_bins")
    arrays = _i32_case(c["n"], c["f"], c["b"], c["width"], seed,
                       skew=c.get("skew", 0.0), member=c.get("member"))
    if tile_bins is None:
        _, _, tile_bins, num_tiles = hist_cuda.i32_plan(c["f"], c["b"])
    else:
        num_tiles = -(-c["b"] // tile_bins)
    return arrays, c["width"], c["f"], c["b"], tile_bins, num_tiles


@pytest.mark.parametrize("case", sorted(I32_WALKS))
def test_int32_walk_replay_is_the_plain_and_jax_f32_histogram(case):
    """The float32 plane's int32 walk, replayed: bitwise the port's plain
    version on integer and on float stats, and the JAX package's
    histogram on integer stats (sums exact in float32)."""
    (binned, grad, hess, live, local), width, f, b, tile_bins, num_tiles = \
        _walk_args(case, seed=11)
    got = _replay_i32(binned, grad, hess, live, local, width, f, b, "f32",
                      tile_bins, num_tiles)
    t = [torch.from_numpy(a) for a in (binned, grad, hess, live, local)]
    np.testing.assert_array_equal(got, hist_cuda.level_histogram_reference(
        *t, width, f, b).numpy())
    want = jax_trainer._level_histogram(
        *(jnp.asarray(a) for a in (binned, grad, hess, live, local)), width,
        f, b)
    np.testing.assert_array_equal(got, np.asarray(want))
    rng = np.random.default_rng(12)
    gf = rng.normal(size=len(grad)).astype(np.float32)
    hf = rng.uniform(0.1, 1.0, size=len(grad)).astype(np.float32)
    got = _replay_i32(binned, gf, hf, live, local, width, f, b, "f32",
                      tile_bins, num_tiles)
    np.testing.assert_array_equal(got, hist_cuda.level_histogram_reference(
        t[0], torch.from_numpy(gf), torch.from_numpy(hf), *t[3:], width, f,
        b).numpy())


@pytest.mark.parametrize("plane", ["q16", "q8"])
@pytest.mark.parametrize("case", sorted(I32_WALKS))
def test_int32_walk_replay_is_the_plain_and_jax_quant_histogram(case, plane):
    """The quantized planes' int32 walk, replayed: bitwise the port's
    plain version and the JAX package's ``per_feature`` histogram, and
    chunk by chunk through the merge entry's epilogue the one pass's
    sums."""
    (binned, _, _, live, local), width, f, b, tile_bins, num_tiles = \
        _walk_args(case, seed=13)
    dtype = np.int16 if plane == "q16" else np.int8
    lim = np.iinfo(dtype)
    rng = np.random.default_rng(14)
    gq = rng.integers(lim.min, lim.max + 1, size=len(live)).astype(dtype)
    hq = rng.integers(0, lim.max + 1, size=len(live)).astype(dtype)
    scales = (2.0 ** -11, 2.0 ** -7)
    arrays = (binned, gq, hq, live, local)
    got = _replay_i32(*arrays, width, f, b, plane, tile_bins, num_tiles,
                      scales=scales)
    t = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_array_equal(got, hist_cuda.level_histogram_quant(
        *t, width, f, b, *scales).numpy())
    want = jax_trainer._level_histogram_quant(
        *(jnp.asarray(a) for a in arrays), width, f, b,
        jnp.float32(scales[0]), jnp.float32(scales[1]),
        formulation="per_feature")
    np.testing.assert_array_equal(got, np.asarray(want))
    acc = np.zeros((width, f, b, 3), np.int64)
    step = -(-len(live) // 3)
    for s in range(0, len(live), step):
        _replay_i32(*(a[s:s + step] for a in arrays), width, f, b, plane,
                    tile_bins, num_tiles, acc=acc)
    np.testing.assert_array_equal(
        acc, hist_cuda.level_histogram_quant_sums_reference(
            *t, width, f, b).numpy())
    np.testing.assert_array_equal(
        hist_cuda.dequantize_sums(torch.from_numpy(acc), *scales).numpy(),
        got)


@pytest.mark.parametrize("f,b", [(28, 65_537), (28, 70_000), (28, 131_072),
                                 (28, 2 ** 20), (1, 65_537), (136, 100_003)])
def test_int32_plans_cover_every_bin_once_and_fit(f, b):
    """On int32 ids both kernels take one feature per item and the fewest
    tiles of bins whose int64 cells fit one CTA's shared memory beside
    its static words (232,448 bytes in all), as even as possible: every
    bin in exactly one tile, none empty; one tile fewer would not fit;
    the tiles' keys (their index's low byte) tell the tiles of one
    feature apart."""
    f_slice, num_slices, tile_bins, num_tiles = hist_cuda.i32_plan(f, b)
    assert (f_slice, num_slices) == (1, f)
    covered = np.zeros(b, np.int64)
    for t in range(num_tiles):
        t0 = t * tile_bins
        assert t0 < b                                  # no tile is empty
        covered[t0:min(b, t0 + tile_bins)] += 1
    assert (covered == 1).all()
    assert tile_bins - (b - (num_tiles - 1) * tile_bins) < num_tiles
    smem = hist_cuda.i32_smem_bytes(tile_bins)
    assert smem + hist_cuda.I32_STATIC_SMEM <= hist_cuda.SMEM_BYTES
    assert hist_cuda.i32_smem_bytes(-(-b // (num_tiles - 1))) \
        + hist_cuda.I32_STATIC_SMEM > hist_cuda.SMEM_BYTES
    assert num_tiles <= 256
    assert hist_cuda._kernel_plan("f32", f, b, 4) == \
        hist_cuda._kernel_plan("quant", f, b, 4) == \
        (1, f, tile_bins, num_tiles, smem)
    want = {65_537: (9363, 7), 70_000: (8750, 8), 131_072: (9363, 14)}
    if f == 28 and b in want:
        assert hist_cuda.i32_plan(f, b)[2:] == want[b]


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("f,b", [(28, 65_537), (28, 131_072), (1, 65_537),
                                 (2, 70_000), (136, 2 ** 20)])
def test_int32_grid_is_at_most_one_wave_of_items(f, b, per_sm):
    """The int32 grid (``launch_grid``, ``hist_grid``'s mirror): at most
    one wave, and no more CTAs than a width-1 level has items, so every
    launched CTA takes one; a CTA per feature of a tile and node."""
    _, num_slices, _, num_tiles = hist_cuda.i32_plan(f, b)
    ctas, per_tile = hist_cuda.launch_grid(132, per_sm, num_slices,
                                           num_tiles, 4)
    assert ctas == min(132 * per_sm, f * num_tiles)
    assert per_tile == num_slices == f


@pytest.mark.parametrize("n,f", [(1, 1), (15, 3), (16, 28), (2_000_000, 28),
                                 (1001, 7)])
def test_int32_scratch_holds_the_columns_and_their_keys(n, f):
    """The int32 scratch: the counter, the node-ordered stats, the (F, N)
    id columns and the (F, stride) key columns, each key column on a
    word (the walk reads the keys four at a time)."""
    stride = hist_cuda.i32_key_stride(n)
    assert stride % 16 == 0 and n <= stride < n + 16
    for stat_bytes in (16, 4):
        want = 16 + n * stat_bytes + 4 * f * n + f * stride
        assert hist_cuda.i32_scratch_bytes(n, f, stat_bytes) == want
        assert (16 + n * stat_bytes + 4 * f * n) % 4 == 0


def test_int32_ids_reach_the_plain_versions_only_on_the_cpu():
    """An int32 histogram on the CPU is the plain version's; no launch
    counter moves (the kernels run only on the card)."""
    t = [torch.from_numpy(a) for a in _i32_case(300, 3, B, 2, seed=15)]
    names = [k for k in vars(hist_cuda) if k.endswith("_launches")
             and isinstance(getattr(hist_cuda, k), int)]
    before = {k: getattr(hist_cuda, k) for k in names}
    assert torch.equal(hist_cuda.level_histogram(*t, 2, 3, B),
                       hist_cuda.level_histogram_reference(*t, 2, 3, B))
    q = (t[1].to(torch.int16), t[2].to(torch.int16))
    acc = torch.zeros((2, 3, B, 3), dtype=torch.int64)
    hist_cuda.level_histogram_quant_sums(t[0], *q, *t[3:], 2, 3, B, acc)
    assert torch.equal(acc, hist_cuda.level_histogram_quant_sums_reference(
        t[0], *q, *t[3:], 2, 3, B))
    assert before == {k: getattr(hist_cuda, k) for k in names}


# --- train on int32 ids ------------------------------------------------------

@pytest.mark.parametrize("sub", ["0", "1"])
def test_int32_fit_is_jax_bitwise_on_q8(monkeypatch, sub):
    _knobs(monkeypatch, "q8", sub)
    x, y, _ = _data()
    binned, upper = _binned(x)
    assert binned.dtype == np.int32
    jr, pr = _fit_both(binned, y, upper, objective="regression",
                       num_iterations=3, num_leaves=12, max_depth=4,
                       max_bin=B)
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)


def test_int32_fit_on_exact_sums_is_jax_bitwise(monkeypatch):
    """The float32 plane with gradients in multiples of 1/8: bit for
    bit."""
    _knobs(monkeypatch, "off")
    x, y, _ = _data()
    binned, upper = _binned(x)
    jr, pr = _fit_both(binned, np.round(y), upper, fobj=dyadic_objective,
                       num_iterations=3, num_leaves=12, max_depth=4,
                       max_bin=B)
    _assert_boosters_equal(pr.booster, jr.booster)


def test_int32_fit_on_float_stats_matches(monkeypatch):
    """Binary on the float32 plane: split features, bins and counts
    exact, node values within ``rtol=1e-5``."""
    _xla_sigmoid(monkeypatch)
    x, _, y = _data()
    binned, upper = _binned(x)
    jr, pr = _fit_both(binned, y, upper, objective="binary",
                       num_iterations=3, num_leaves=12, max_depth=4,
                       max_bin=B)
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-5, atol=1e-7)


def test_leafwise_int32_fit_is_jax_bitwise(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_GROW_POLICY", "leafwise")
    monkeypatch.setenv(trainer.GROW_POLICY_ENV, "leafwise")
    x, y, _ = _data()
    binned, upper = _binned(x)
    jr, pr = _fit_both(binned, np.round(y), upper, fobj=dyadic_objective,
                       num_iterations=3, num_leaves=8, max_depth=4,
                       min_data_in_leaf=20, max_bin=B)
    assert pr.hist_stats["grow_policy"] == "leafwise"
    _assert_boosters_equal(pr.booster, jr.booster)


def test_dart_int32_fit_is_jax_bitwise_on_q8(monkeypatch):
    _knobs(monkeypatch, "q8")
    x, y, _ = _data()
    binned, upper = _binned(x)
    jr, pr = _fit_both(binned, y, upper, objective="regression",
                       boosting_type="dart", drop_rate=0.5, skip_drop=0.0,
                       num_iterations=4, num_leaves=8, max_depth=3,
                       max_bin=B)
    assert (pr.booster.tree_weights < 1).any()        # trees were dropped
    _assert_boosters_equal(pr.booster, jr.booster)


def _one_hot_data(n=1500, dense=3, fields=(4, 6), seed=5):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(n, dense))]
    signal = 1.2 * x[0][:, 0]
    for k in fields:
        cat = rng.integers(0, k, size=n)
        block = np.zeros((n, k))
        block[np.arange(n), cat] = 1.0
        x.append(block)
        signal = signal + (cat % 3 == 0)
    return np.hstack(x), np.round(signal + rng.normal(size=n) * 0.5)


def test_efb_on_int32_ids_is_the_references(monkeypatch):
    """The plan made on int32 ids, the bundled int32 matrix, and an EFB
    fit on q8: the JAX package's bit for bit."""
    x, y = _one_hot_data()
    binned, upper = _binned(x)
    ids = trainer._binned_to_device(binned, B, torch.device("cpu"))
    got = efb.plan_bundles(ids, B, mode="on")
    want = jax_efb.plan_bundles(binned, B, mode="on")
    assert got is not None and got.bundles and got.cache_key == want.cache_key
    bundled = efb.apply_plan(ids, got)
    assert bundled.dtype == torch.int32
    np.testing.assert_array_equal(bundled.numpy(),
                                  jax_efb.apply_plan(binned, want))
    _knobs(monkeypatch, "q8", bundling="on")
    jr, pr = _fit_both(binned, y, upper, objective="regression",
                       num_iterations=3, num_leaves=12, max_depth=4,
                       max_bin=B, min_data_in_leaf=10)
    assert pr.hist_stats["efb_bundles"] == jr.hist_stats["efb_bundles"] > 0
    _assert_boosters_equal(pr.booster, jr.booster)


def test_streamed_int32_fit_is_the_in_core_fit(monkeypatch):
    """``MMLSPARK_TORCH_OOC=on`` streams the int32 ids through the spill
    plane in chunks: the in-core fit's trees (and the reference's, q8)
    bit for bit."""
    _knobs(monkeypatch, "q8")
    monkeypatch.setattr(trainer, "OOC_CHUNK_ROWS", 512)
    x, y, _ = _data()
    binned, upper = _binned(x)
    cfg = dict(objective="regression", num_iterations=3, num_leaves=12,
               max_depth=4, max_bin=B)
    jr, in_core = _fit_both(binned, y, upper, **cfg)
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "on")
    streamed = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                             bin_upper=upper, device="cpu")
    assert streamed.hist_stats["ooc"] and streamed.hist_stats["n_chunks"] == 4
    _assert_boosters_equal(streamed.booster, in_core.booster)
    _assert_boosters_equal(streamed.booster, jr.booster)


def test_estimator_at_max_bin_70000_is_jax_bitwise(monkeypatch):
    """``LightGBMClassifier(maxBin=70000)`` fit and transform, raw and
    binned: the JAX estimator's bit for bit on q8."""
    _knobs(monkeypatch, "q8")
    _xla_sigmoid(monkeypatch)
    x, _, y = _data(n=1500)
    cols = {"features": x, "label": y}
    kw = dict(numIterations=4, numLeaves=12, maxDepth=4, maxBin=B)
    port = estimators.LightGBMClassifier(**kw).set_device("cpu").fit(
        DataFrame(cols))
    ref = jax_est.LightGBMClassifier(**kw).fit(JaxFrame(cols))
    _assert_boosters_equal(port.booster, ref.booster)
    for binned in (False, True):
        port.set("binnedScoring", binned)
        ref.set("binnedScoring", binned)
        got = port.transform(DataFrame({"features": x}))
        want = ref.transform(JaxFrame({"features": x}))
        for col in ("rawPrediction", "probability", "prediction"):
            np.testing.assert_array_equal(got[col], want[col])


# --- settings that raised for max_bin past 65,536 ---------------------------

DRAWS = dict(drop_rate=0.5, skip_drop=0.0)
FITS = {
    "dart": dict(objective="regression", boosting_type="dart", **DRAWS),
    "dart_bagged": dict(objective="regression", boosting_type="dart",
                        bagging_fraction=0.8, bagging_freq=1, **DRAWS),
    "multiclass": dict(objective="multiclass", num_class=3),
    "multiclass_dart": dict(objective="multiclass", num_class=3,
                            boosting_type="dart", **DRAWS),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_dart_bagged_and_multiclass_int32_fits_are_jax_bitwise(monkeypatch,
                                                               case):
    """DART alone and with bagging (the host loop's numpy streams), and
    multiclass with and without DART, on int32 ids and q8: the JAX
    package's booster bit for bit."""
    _knobs(monkeypatch, "q8")
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(
        np.array(jnp.exp(t.numpy()))))
    x, y, _ = _data(n=900)
    if FITS[case]["objective"] == "multiclass":
        y = np.digitize(y, [-0.7, 0.7]).astype(np.float64)
    binned, upper = _binned(x)
    jr, pr = _fit_both(binned, y, upper, num_iterations=3, num_leaves=8,
                       max_depth=3, max_bin=B, **FITS[case])
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals, rtol=1e-5)
    if "boosting_type" in FITS[case]:
        assert (pr.booster.tree_weights < 1).any()    # trees were dropped


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_lambdarank_int32_fit_is_jax_bitwise_given_its_grads(monkeypatch,
                                                             boosting):
    """lambdarank with the ndcg metric on int32 ids, plain and under
    DART, given the JAX package's gradients on both sides: its booster
    bit for bit, ndcg within ``rtol=1e-6``."""
    from tests.test_torch_ranking import _jax_grads, _rank_data

    _knobs(monkeypatch, "q8")
    x, y, gid = _rank_data("uniform", seed=2)
    binned, upper = _binned(x)
    assert binned.dtype == np.int32
    jfobj, pfobj = _jax_grads(gid)
    kw = dict(objective="lambdarank", metric="ndcg", eval_at=(3, 5),
              boosting_type=boosting, num_iterations=3, num_leaves=8,
              max_depth=3, max_bin=B, min_data_in_leaf=10,
              **(DRAWS if boosting == "dart" else {}))
    want = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**kw),
                             bin_upper=upper, group_ids=gid,
                             custom_objective=jfobj)
    got = trainer.train(binned, y, trainer.TrainConfig(**kw),
                        bin_upper=upper, group_ids=gid,
                        custom_objective=pfobj, device="cpu")
    _assert_boosters_equal(got.booster, want.booster)
    _assert_evals_match(got.evals, want.evals)
    assert "train_ndcg@5" in got.evals[-1]


ESTIMATORS = {
    "dart": ("LightGBMClassifier", {"boostingType": "dart"}),
    "dart_fraction_by_node": ("LightGBMClassifier", {
        "featureFraction": 0.5, "featureFractionByNode": 0.5,
        "boostingType": "dart"}),
    "dart_bagged": ("LightGBMClassifier", {
        "baggingFraction": 0.5, "baggingFreq": 1, "boostingType": "dart"}),
    "extra_trees": ("LightGBMClassifier", {"extraTrees": True}),
    "pass_through": ("LightGBMRegressor", {
        "passThroughArgs": "bagging_fraction=0.5 bagging_freq=1 "
                           "boosting_type=dart max_bin=70000"}),
}


@pytest.mark.parametrize("case", sorted(ESTIMATORS))
def test_estimator_settings_at_max_bin_70000_are_jax_bitwise(monkeypatch,
                                                             case):
    """The estimators' DART, bagged, per-node and extra-trees settings at
    ``maxBin`` 70,000 (through ``passThroughArgs`` too), with the
    reference's draws on q8: the JAX estimator's booster and transform
    bit for bit."""
    from mmlspark_tpu_torch.models.gbdt import sampling
    from tests.test_torch_breadth import jax_tree_draw

    _knobs(monkeypatch, "q8")
    _xla_sigmoid(monkeypatch)
    monkeypatch.setattr(sampling, "draw", jax_tree_draw(B))
    kind, params = ESTIMATORS[case]
    x, y, y_bin = _data(n=1000)
    label = y_bin if kind == "LightGBMClassifier" else y
    cols = {"features": x, "label": label}
    kw = dict(params, numIterations=3, numLeaves=8, maxDepth=3)
    if "passThroughArgs" not in params:
        kw["maxBin"] = B
    port = getattr(estimators, kind)(**kw).set_device("cpu").fit(
        DataFrame(cols))
    ref = getattr(jax_est, kind)(**kw).fit(JaxFrame(cols))
    _assert_boosters_equal(port.booster, ref.booster)
    got = port.transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    np.testing.assert_array_equal(got["prediction"], want["prediction"])


# --- binned scoring past what a 32-bit bin node holds -----------------------

def _stump(feature, threshold, num_features):
    sf = np.full((1, 3), -1, np.int32)
    sf[0, 0] = feature
    tb = np.zeros((1, 3), np.int32)
    tb[0, 0] = threshold
    return dict(split_feature=sf, threshold_bin=tb,
                threshold_value=np.full((1, 3), np.inf),
                node_value=np.array([[0.0, -1.0, 1.0]], np.float32),
                count=np.zeros((1, 3), np.float32),
                tree_weights=np.ones(1, np.float32), max_depth=1,
                num_features=num_features)


def _wide_arrays(seed, trees, depth, k, features, max_bin):
    """A random full-layout ensemble whose roots split on one of the last
    two features at a threshold in the top half of ``max_bin``, its other
    nodes anywhere below: split features past 32,767 and thresholds past
    65,534 where ``features`` and ``max_bin`` reach them."""
    rng = np.random.default_rng(seed)
    m = 2 ** (depth + 1) - 1
    sf = np.full((trees, m), -1, np.int32)
    tb = np.zeros((trees, m), np.int32)
    for t in range(trees):
        for node in range(2 ** depth - 1):
            if node == 0 or (sf[t, (node - 1) // 2] >= 0
                             and rng.random() < 0.8):
                sf[t, node] = rng.integers(features)
                tb[t, node] = rng.integers(max_bin)
        sf[t, 0] = features - 1 - t % 2
        tb[t, 0] = rng.integers(max_bin // 2, max_bin)
    return dict(split_feature=sf, threshold_bin=tb,
                threshold_value=np.full((trees, m), np.inf),
                node_value=rng.normal(size=(trees, m)).astype(np.float32),
                count=np.zeros((trees, m), np.float32),
                tree_weights=rng.uniform(0.3, 1.7, trees).astype(np.float32),
                max_depth=depth, num_features=features, num_class=k,
                init_score=0.123456789)


def test_binned_scoring_past_uint16_thresholds_is_the_reference():
    """A split at ``threshold_bin`` 70,000, and one on feature 40,000:
    the port's binned scoring raised where the reference scores; now the
    wide tables' plain version and ``TreeScorer`` return the reference's
    ``predict_binned_jit()`` bit for bit."""
    x = np.array([[69_999], [70_000], [70_001], [5]], np.int32)
    arrays = _stump(0, 70_000, 1)
    want = np.asarray(JaxBooster(**arrays).predict_binned_jit()(x))
    assert want.tolist() == [-1.0, -1.0, 1.0, -1.0]
    booster = BoosterArrays(**arrays)
    assert booster.supports_binned
    np.testing.assert_array_equal(
        booster.predict_binned(x, device="cpu").numpy(), want)
    rng = np.random.default_rng(21)
    for arrays, x in (
            (_stump(40_000, 3, 40_001),
             rng.integers(0, 8, size=(9, 40_001)).astype(np.uint8)),
            (_wide_arrays(22, 12, 4, 2, 40_001, 131_072),
             rng.integers(0, 131_073, size=(9, 40_001)).astype(np.int32)),
            (_wide_arrays(23, 30, 5, 1, 6, B),
             rng.integers(0, B + 1, size=(200, 6)).astype(np.int32))):
        want = np.asarray(JaxBooster(**arrays).predict_binned_jit()(x))
        scorer = BoosterArrays(**arrays).predict_binned_scorer("off", "cpu")
        tables = scorer.tables
        assert tables.wide and tables.route == "wide"
        np.testing.assert_array_equal(scorer(x).numpy(), want)
        np.testing.assert_array_equal(score_cuda.tree_score_reference(
            torch.from_numpy(x), tables).numpy(), want)


def test_wide_nodes_unpack_and_keep_narrow_boosters_narrow():
    """A booster within a word keeps 32-bit nodes; past it each node is
    {int32 feature, int32 threshold}, a leaf above the last level pushed
    down behind always-left nodes of threshold int32's largest."""
    narrow = BoosterArrays(**_stump(0, 65_534, 1))
    assert not narrow.predict_binned_scorer("off", "cpu").tables.wide
    arrays = _wide_arrays(24, 3, 3, 1, 6, B)
    arrays["threshold_bin"][0, 0] = 69_999
    arrays["split_feature"][0, 2] = -1            # a leaf on level 1
    tables = BoosterArrays(**arrays).predict_binned_scorer("off",
                                                           "cpu").tables
    assert tables.wide
    feat, thr = (v.numpy() for v in score_cuda.unpack_nodes(tables))
    internal = (arrays["split_feature"] >= 0).reshape(-1)
    np.testing.assert_array_equal(
        feat[internal], arrays["split_feature"].reshape(-1)[internal])
    np.testing.assert_array_equal(
        thr[internal], arrays["threshold_bin"].reshape(-1)[internal])
    assert (feat[2], thr[2]) == (0, score_cuda.ALWAYS_LEFT_WIDE)
    assert score_cuda._x_code(torch.int32, tables) == 12
    assert score_cuda._x_code(torch.uint8, tables) == 9


@pytest.mark.parametrize("case", ["rows", "cluster", "rows_one_sm",
                                  "global_deep", "uint16_rows"])
def test_the_kernels_loops_on_wide_tables_give_the_plain_bits(case):
    """The kernel's loops replayed on wide tables under each plan (the
    rows plan's chunks and tiles, the cluster's ranks, the global route):
    the plain version's bits, ids past 65,535 compared unclamped."""
    trees, depth, k, n, plan_of = {
        "rows": (300, 6, 3, 40, "rows"),
        "cluster": (100, 6, 1, 37, "cluster"),
        "rows_one_sm": (20, 5, 2, 1100, "rows_one_sm"),
        "global_deep": (3, 14, 1, 9, "rows"),
        "uint16_rows": (60, 5, 1, 50, "rows")}[case]
    dtype = torch.uint16 if case == "uint16_rows" else torch.int32
    features = 40_001 if case == "uint16_rows" else 6
    max_bin = 60_000 if case == "uint16_rows" else 131_072
    arrays = _wide_arrays(30 + len(case), trees, depth, k, features, max_bin)
    tables = BoosterArrays(**arrays).predict_binned_scorer("off",
                                                           "cpu").tables
    assert tables.wide
    ids = np.random.default_rng(31).integers(0, max_bin + 1,
                                             size=(n, features))
    x32 = torch.from_numpy(ids.astype(np.int32))
    x = x32 if dtype == torch.int32 else torch.from_numpy(
        ids.astype(np.uint16).view(np.int16)).view(torch.uint16)
    m = tables.num_nodes
    plan = {"rows": lambda: score_cuda.rows_plan(n, trees, m, k, dtype,
                                                 features, wide=True),
            "cluster": lambda: score_cuda.cluster_plan(
                n, trees, m, k, dtype, features, wide=True),
            "rows_one_sm": lambda: score_cuda.rows_plan(
                n, trees, m, k, dtype, features, sms=1, wide=True)}[plan_of]()
    assert plan is not None
    if case == "global_deep" or case == "uint16_rows":
        assert plan.tables == "global"
    want = score_cuda.tree_score_reference(x, tables).numpy()
    np.testing.assert_array_equal(_replay(x32, tables, plan), want)
    np.testing.assert_array_equal(
        want, np.asarray(JaxBooster(**arrays).predict_binned_jit()(
            ids.astype(np.int32))))


def _many_thresholds(trees=1200, depth=6, objective="regression"):
    """A full-layout ensemble of random raw thresholds, about 95% of the
    splits on feature 0 of two: more than 65,534 distinct thresholds
    there, as an imported model's derived binning meets them."""
    rng = np.random.default_rng(40)
    m = 2 ** (depth + 1) - 1
    sf = np.full((trees, m), -1, np.int32)
    # about 95% of the splits on feature 0
    sf[:, :2 ** depth - 1] = rng.random((trees, 2 ** depth - 1)) < 0.05
    tv = np.full((trees, m), np.inf)
    tv[:, :2 ** depth - 1] = rng.normal(size=(trees, 2 ** depth - 1))
    arrays = dict(split_feature=sf,
                  threshold_bin=np.full((trees, m), -1, np.int32),
                  threshold_value=tv,
                  node_value=rng.normal(size=(trees, m)).astype(np.float32),
                  count=np.zeros((trees, m), np.float32),
                  tree_weights=np.full(trees, 0.1, np.float32),
                  max_depth=depth, num_features=2, objective=objective)
    return arrays


def test_imported_model_past_65536_thresholds_scores_binned_as_jax():
    """An imported model (raw thresholds only) with more than 65,534
    distinct thresholds on a feature: its derived binning gives int32
    ids, its thresholds pass a 32-bit node, and the binned scorer (wide
    nodes) gives the JAX package's derived binned scores bit for bit."""
    arrays = _many_thresholds()
    rng = np.random.default_rng(41)
    binning, derived = BoosterArrays(**arrays).derive_binning()
    jbinning, jderived = JaxBooster(**arrays).derive_binning()
    assert binning.num_bins > 65_536 and binning.dtype == np.int32
    x = rng.normal(size=(300, 2))
    ids = binning.transform(x)
    np.testing.assert_array_equal(ids, jbinning.transform(x))
    scorer = derived.predict_binned_scorer("off", "cpu")
    assert scorer.tables.wide
    np.testing.assert_array_equal(
        scorer(ids).numpy(),
        np.asarray(jderived.predict_binned_jit()(ids)))


def test_imported_model_serves_int32_rows_through_the_wide_route(
        monkeypatch):
    """The serving plane of such an imported model string: int32 ids
    from its derived binning, scored through wide nodes, as the JAX
    plan's bit for bit; a server with the binned plane on replies with
    the plan's columns."""
    from mmlspark_tpu.models.gbdt import estimators as jax_estimators
    from mmlspark_tpu_torch.io.serving import ServingServer
    from tests.test_torch_serving import _assert_replies_equal, _score_rows

    text = BoosterArrays(**_many_thresholds(
        trees=1100, objective="binary")).save_model_string()
    port = estimators.LightGBMClassificationModel \
        .load_native_model_from_string(text).set_device("cpu")
    ref = jax_estimators.LightGBMClassificationModel \
        .load_native_model_from_string(text)
    pplan, jplan = port.serving_binned_plan(), ref.serving_binned_plan()
    assert np.dtype(pplan.ingest_dtype) == np.dtype(jplan.ingest_dtype) \
        == np.int32
    assert pplan.score.tables.wide
    rows = np.random.default_rng(42).normal(size=(24, 2))
    pb, jb = pplan.bin_rows(rows), jplan.bin_rows(rows)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pplan.score(pb).numpy(),
                                  np.asarray(jplan.score(jb)))
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    with ServingServer(port, max_batch_size=8,
                       max_latency_ms=2.0) as server:
        replies = _score_rows(server, rows)
    _assert_replies_equal(pplan.finish(pplan.score(pb).numpy()), replies)

"""The port's quantized-gradient plane and histogram subtraction
(``MMLSPARK_TORCH_HIST_QUANT`` / ``MMLSPARK_TORCH_HIST_SUB``, on the CPU,
where the wrappers run their plain versions) against the JAX package's
(``MMLSPARK_TPU_HIST_QUANT`` / ``MMLSPARK_TPU_HIST_SUB``, histogram
formulation pinned to ``per_feature``) on the same numpy inputs.

Tolerances, by case:

  - ``_pow2_scale``: the exponent equal at every tested amax; the value
    bit for bit wherever the JAX result is an exact power of two. XLA on
    the CPU evaluates ``jnp.exp2`` as ``exp(x * ln 2)``, which is not
    exact at some integer exponents (13, 15, ...); the port keeps the
    exact power of two, the reference's documented contract.
  - quantized histograms: bit for bit against the XLA mirror and the
    Pallas kernel in interpret mode (N <= 65,536, where the mirror
    rounds once) and against a numpy int64 reference at any N.
  - ``_derive_sibling_hist``: bit for bit.
  - L2 fits, q16/q8 x subtraction off/on: every ``BoosterArrays`` array
    bit for bit. The data keep every bin-axis partial sum of the
    dequantized stats exact in float32 (integer partials below 2^24),
    so no summation order can move a bit. Where sums round
    (``test_q16_fit_where_bin_sums_round``) XLA reduces a bin axis in
    another order than torch: splits and counts stay equal and node
    values agree to ``rtol=1e-5, atol=1e-6``.
  - binary, 5 trees, q16: splits equal, training logloss within 1e-6
    relative.
  - float32 with subtraction: splits and counts equal, node values to
    ``rtol=1e-5, atol=1e-7`` (float sums in another order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.hist_pallas import pallas_level_histogram_quant
from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
from mmlspark_tpu_torch.models.gbdt import trainer
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_gbdt_hist import _replay_quant_kernel

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 63
QMAX = {"q16": 32000.0, "q8": 120.0}
QDT = {"q16": np.int16, "q8": np.int8}


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)
    env.reset_warnings()


def _set_knobs(monkeypatch, quant, sub):
    """The same plane on both sides: JAX knobs and the port's."""
    for jax_name, port_name, value in (
            ("MMLSPARK_TPU_HIST_QUANT", trainer.HIST_QUANT_ENV, quant),
            ("MMLSPARK_TPU_HIST_SUB", trainer.HIST_SUB_ENV, sub)):
        monkeypatch.setenv(jax_name, value)
        monkeypatch.setenv(port_name, value)


# --- _pow2_scale --------------------------------------------------------------

def _amax_grid():
    """Powers of two, qmax * powers of two, and 3 ulps either side of
    each; tiny values, zero and the largest float."""
    vals = [0.0, 1e-30, 1e-31, 1e-38, 1e-45, 3.4028235e38]
    for j in range(-149, 128):
        for base in (np.ldexp(1.0, j), 32000.0 * np.ldexp(1.0, j),
                     120.0 * np.ldexp(1.0, j)):
            if not np.ldexp(1.0, -149) <= base <= 3.4028234e38:
                continue
            x = np.float32(base)
            up = down = x
            vals.append(x)
            for _ in range(3):
                up = np.nextafter(up, np.float32(np.inf))
                down = np.nextafter(down, np.float32(0))
                vals += [up, down]
    grid = np.unique(np.array(vals, np.float32))
    return grid[np.isfinite(grid)]


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_pow2_scale_matches_jax(quant):
    amax = _amax_grid()
    js, jsi = (np.asarray(v) for v in
               jax_trainer._pow2_scale(jnp.asarray(amax), QMAX[quant]))
    ps, psi = (v.numpy() for v in
               trainer._pow2_scale(torch.from_numpy(amax), QMAX[quant]))
    # the port's scales are exact powers of two, inverse to each other
    e_port = np.log2(ps.astype(np.float64))
    np.testing.assert_array_equal(e_port, np.round(e_port))
    np.testing.assert_array_equal(ps.astype(np.float64) * psi, 1.0)
    assert e_port.min() >= -126 and e_port.max() <= 126
    # the floor decision is JAX's at every amax of the grid
    np.testing.assert_array_equal(
        e_port, np.round(np.log2(js.astype(np.float64))))
    # and the value is JAX's wherever XLA's exp2 gave a power of two
    for want, got in ((js, ps), (jsi, psi)):
        exact = want == np.exp2(np.round(np.log2(want.astype(np.float64))))
        assert exact.sum() > 100
        np.testing.assert_array_equal(got[exact], want[exact])


# --- the quantized level histogram -------------------------------------------

def _quant_case(n, f, b, width, quant, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    live = (rng.random(n) < 0.9).astype(np.float32)
    local = rng.integers(0, width, size=n).astype(np.int32)
    gs, gsi = trainer._pow2_scale(torch.tensor(np.abs(grad * live).max()),
                                  QMAX[quant])
    hs, hsi = trainer._pow2_scale(torch.tensor(np.abs(hess * live).max()),
                                  QMAX[quant])
    gq = np.rint(grad * live * gs.item()).astype(QDT[quant])
    hq = np.rint(hess * live * hs.item()).astype(QDT[quant])
    return binned, gq, hq, live, local, gsi.item(), hsi.item()


def _int64_reference(binned, gq, hq, live, local, width, b, gsi, hsi):
    """numpy int64 sums over the rows with live > 0, one float32 rounding
    of ``sum * float64(scale_inv)``."""
    n, f = binned.shape
    gate = live > 0
    out = np.zeros((width, f, b, 3), np.float32)
    chans = (np.where(gate, gq, 0).astype(np.int64),
             np.where(gate, hq, 0).astype(np.int64), gate.astype(np.int64))
    for j in range(f):
        idx = local.astype(np.int64) * b + binned[:, j]
        for c, (w, s) in enumerate(zip(chans, (gsi, hsi, 1.0))):
            sums = np.zeros(width * b, np.int64)
            np.add.at(sums, idx, w)
            out[:, j, :, c] = (sums.reshape(width, b)
                               * np.float64(s)).astype(np.float32)
    return out


def _port_quant(case, width, f, b):
    binned, gq, hq, live, local, gsi, hsi = case
    t = [torch.from_numpy(x) for x in (binned, gq, hq, live, local)]
    out = H.level_histogram_quant(*t, width, f, b, gsi, hsi)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    return out.numpy()


QUANT_SHAPES = [
    (2000, 7, 32, 4),     # generic
    (999, 3, 255, 8),     # full bin range
    (100, 5, 16, 16),     # more nodes than rows per node; empty nodes
    (4096, 2, 64, 1),     # root level
]


@pytest.mark.parametrize("quant", ["q16", "q8"])
@pytest.mark.parametrize("n,f,b,width", QUANT_SHAPES)
def test_quant_histogram_matches_jax_bitwise(quant, n, f, b, width):
    case = _quant_case(n, f, b, width, quant)
    binned, gq, hq, live, local, gsi, hsi = case
    got = _port_quant(case, width, f, b)
    xla = np.asarray(jax_trainer._level_histogram_quant(
        jnp.asarray(binned), jnp.asarray(gq), jnp.asarray(hq),
        jnp.asarray(live), jnp.asarray(local), width, f, b,
        jnp.float32(gsi), jnp.float32(hsi), formulation="per_feature"))
    pallas = np.asarray(pallas_level_histogram_quant(
        jnp.asarray(binned), jnp.asarray(gq), jnp.asarray(hq),
        jnp.asarray(live), jnp.asarray(local), width, f, b,
        jnp.float32(gsi), jnp.float32(hsi), interpret=True))
    assert got.shape == (width, f, b, 3)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, _int64_reference(binned, gq, hq, live, local, width, b, gsi,
                              hsi))


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_quant_histogram_past_the_xla_chunk_matches_int64(quant):
    """Above 65,536 rows the XLA mirror rounds once per chunk; the port
    keeps the native contract, one rounding of the exact int64 sum."""
    n, f, b, width = 70_000, 3, 16, 2
    case = _quant_case(n, f, b, width, quant, seed=3)
    binned, gq, hq, live, local, gsi, hsi = case
    np.testing.assert_array_equal(
        _port_quant(case, width, f, b),
        _int64_reference(binned, gq, hq, live, local, width, b, gsi, hsi))


def test_quant_histogram_gates_on_live_above_zero():
    """Rows count where live > 0 and weigh 1 whatever live's value, as
    in the XLA mirror (``trainer.py``: ``gate = live > 0``): the plain
    version, and the replayed card kernel, whose partition keeps live > 0
    (``tests/test_torch_gbdt_hist.py``)."""
    n, f, b, width = 600, 3, 8, 2
    binned, gq, hq, _, local, gsi, hsi = _quant_case(n, f, b, width, "q16")
    live = np.random.default_rng(5).choice(
        np.float32([0.0, 1.0, 0.5, -1.0, 2.0]), size=n)
    case = (binned, gq, hq, live, local, gsi, hsi)
    xla = np.asarray(jax_trainer._level_histogram_quant(
        *(jnp.asarray(x) for x in (binned, gq, hq, live, local)), width, f,
        b, jnp.float32(gsi), jnp.float32(hsi), formulation="per_feature"))
    np.testing.assert_array_equal(_port_quant(case, width, f, b), xla)
    walked, seen, _, _ = _replay_quant_kernel(
        binned, gq, hq, live, local, width, f, b, gsi, hsi, 32, 3, f,
        H.quant_window(16))
    np.testing.assert_array_equal(seen[0], (live > 0).astype(np.int64))
    np.testing.assert_array_equal(walked, xla)


def test_empty_quant_histogram_is_zero():
    out = H.level_histogram_quant(
        torch.zeros((0, 3), dtype=torch.uint8),
        torch.zeros(0, dtype=torch.int16), torch.zeros(0, dtype=torch.int16),
        torch.zeros(0), torch.zeros(0, dtype=torch.int64), 4, 3, 8, 1.0, 1.0)
    assert out.shape == (4, 3, 8, 3) and not out.any()


def test_quant_wrapper_rejects_inputs_the_kernel_does_not_take():
    binned, gq, hq, live, local, gsi, hsi = (
        torch.as_tensor(x) for x in _quant_case(50, 3, 16, 2, "q16"))
    ok = (binned, gq, hq, live, local, 2, 3, 16, gsi, hsi)
    H.level_histogram_quant(*ok)
    bad = [
        (binned, gq.int(), hq.int()) + ok[3:],          # int32 stats
        (binned, gq, hq.to(torch.int8)) + ok[3:],       # mixed dtypes
        (binned, gq.float(), hq.float()) + ok[3:],      # float stats
        ok[:3] + (live.double(),) + ok[4:],             # live not float32
        ok[:8] + (torch.ones(2), hsi),                  # scale not a scalar
    ]
    for args in bad:
        with pytest.raises(ValueError):
            H.level_histogram_quant(*args)


# --- subtraction ---------------------------------------------------------------

@pytest.mark.parametrize("width", [2, 4, 16])
def test_derive_sibling_hist_matches_jax(width):
    rng = np.random.default_rng(width)
    f, b = 3, 8
    prev_hist = rng.normal(size=(width // 2, f, b, 3)).astype(np.float32)
    prev_hist[..., 1:] = np.abs(prev_hist[..., 1:]) * 4
    hist_small = (prev_hist[np.arange(width) // 2]
                  * rng.uniform(0, 1.2, size=(width, f, b, 3))
                  ).astype(np.float32)
    prev_split = rng.random(width // 2) < 0.7
    prev_ss = rng.integers(0, 2, size=width // 2).astype(np.int32)
    want = np.asarray(jax_trainer._derive_sibling_hist(
        jnp.asarray(hist_small), jnp.asarray(prev_hist),
        jnp.asarray(prev_split), jnp.asarray(prev_ss)))
    got = trainer._derive_sibling_hist(
        torch.from_numpy(hist_small), torch.from_numpy(prev_hist),
        torch.from_numpy(prev_split), torch.from_numpy(prev_ss).long())
    assert (want[..., 1:] == 0).any()          # the clamps were exercised
    np.testing.assert_array_equal(got.numpy(), want)


# --- fits ----------------------------------------------------------------------

def _fit_data(n=2000, f=6, seed=0):
    """Regression labels mostly in [0, 1] with 1% outliers at +5: the
    outliers set the gradient scale (q16 exponent 12 every round) and
    the rest keep bin-axis sums of the quantized gradient far below
    2^24 quanta, exact in float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.03] = np.nan
    core = np.nan_to_num(0.3 * x[:, 0] + 0.5 + 0.2 * x[:, 1] * x[:, 2])
    y = np.clip(core, 0, 1) + 5.0 * (rng.random(n) < 0.01)
    logit = 1.5 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1])
    y_bin = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y, y_bin


def _fit_both(x, y, **kw):
    cfg = dict(max_bin=MAX_BIN, max_depth=4, num_leaves=15,
               min_data_in_leaf=20, **kw)
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(MAX_BIN)
    jr = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, device="cpu")
    return jr, pr


@pytest.mark.parametrize("sub", ["0", "1"])
@pytest.mark.parametrize("quant", ["q16", "q8"])
@pytest.mark.parametrize("trees,extra", [
    (1, {"boost_from_average": False}),
    (1, {"lambda_l2": 1.0, "path_smooth": 3.0, "max_delta_step": 0.7}),
    (5, {}),
])
def test_quantized_l2_fit_is_bitwise(monkeypatch, quant, sub, trees, extra):
    _set_knobs(monkeypatch, quant, sub)
    x, y, _ = _fit_data()
    jr, pr = _fit_both(x, y, objective="regression", num_iterations=trees,
                       **extra)
    assert jr.hist_stats["hist_quant"] == quant
    assert pr.hist_stats == {"hist_quant": quant, "subtract": sub == "1"}
    assert (jr.booster.split_feature >= 0).sum() >= 5 * trees  # real trees
    for name in ARRAYS:
        want, got = getattr(jr.booster, name), getattr(pr.booster, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pr.booster.init_score == jr.booster.init_score


def test_q16_fit_where_bin_sums_round(monkeypatch):
    """Labels 0..12 at 20,000 rows: bin-axis sums of the dequantized
    gradient pass 2^24 quanta and round in float32, and XLA sums a bin
    axis in another order than torch. Histograms stay bit-identical, so
    splits and counts do; node values move in the last bits."""
    _set_knobs(monkeypatch, "q16", "0")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20_000, 6))
    y = np.round(np.clip(x[:, 0] * 3 + 5 + 2 * x[:, 1] * x[:, 2], 0, 12))
    jr, pr = _fit_both(x, y, objective="regression", num_iterations=3)
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sub", ["0", "1"])
def test_q16_binary_fit_matches(monkeypatch, sub):
    _set_knobs(monkeypatch, "q16", sub)
    x, _, y_bin = _fit_data(seed=1)
    jr, pr = _fit_both(x, y_bin, objective="binary", num_iterations=5)
    for name in ("split_feature", "threshold_bin", "threshold_value",
                 "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    for je, pe in zip(jr.evals, pr.evals):
        np.testing.assert_allclose(pe["train_binary_logloss"],
                                   je["train_binary_logloss"], rtol=1e-6)
    lls = [e["train_binary_logloss"] for e in pr.evals]
    assert lls[-1] < lls[0]


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_f32_fit_with_subtraction_matches(monkeypatch, objective):
    _set_knobs(monkeypatch, "off", "1")
    x, y, y_bin = _fit_data(seed=2)
    jr, pr = _fit_both(x, y if objective == "regression" else y_bin,
                       objective=objective, num_iterations=5)
    assert pr.hist_stats == {"hist_quant": "off", "subtract": True}
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-5, atol=1e-7)


def test_subtraction_leaves_the_port_fit_unchanged_on_exact_stats(
        monkeypatch):
    """On the quantized plane the derived sibling is exact, so the fit
    with subtraction equals the fit without it."""
    x, y, _ = _fit_data(seed=4)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    cfg = trainer.TrainConfig(objective="regression", num_iterations=3,
                              max_bin=MAX_BIN, max_depth=4, num_leaves=15)
    fits = {}
    for sub in ("0", "1"):
        _set_knobs(monkeypatch, "q8", sub)
        fits[sub] = trainer.train(binned, y, cfg, device="cpu").booster
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(fits["0"], name),
                                      getattr(fits["1"], name))


@pytest.mark.parametrize("knob,bad", [
    (trainer.HIST_QUANT_ENV, "q4"), (trainer.HIST_SUB_ENV, "maybe")])
def test_bad_knob_values_warn_once_and_run_off(monkeypatch, knob, bad):
    x, y, _ = _fit_data(n=400)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    cfg = trainer.TrainConfig(objective="regression", num_iterations=1,
                              max_bin=MAX_BIN, max_depth=3, num_leaves=8)
    plain = trainer.train(binned, y, cfg, device="cpu")
    monkeypatch.setenv(knob, bad)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fits = [trainer.train(binned, y, cfg, device="cpu")
                for _ in range(2)]
    named = [w for w in caught if knob in str(w.message)]
    assert len(named) == 1, [str(w.message) for w in caught]
    for fit in fits:
        assert fit.hist_stats == {"hist_quant": "off", "subtract": False}
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(fit.booster, name),
                                          getattr(plain.booster, name))


@pytest.mark.parametrize("value,want", [
    ("", "off"), ("off", "off"), ("q16", "q16"), (" Q8 ", "q8")])
def test_resolve_hist_quant(monkeypatch, value, want):
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, value)
    assert trainer.resolve_hist_quant() == want


@pytest.mark.parametrize("value,want", [
    ("", False), ("0", False), ("1", True), ("on", True), ("off", False)])
def test_resolve_subtract(monkeypatch, value, want):
    monkeypatch.setenv(trainer.HIST_SUB_ENV, value)
    assert trainer.resolve_subtract() is want

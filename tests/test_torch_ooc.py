"""Out-of-core GBDT training in the port (``models/gbdt/ooc.py``, the
dispatch in ``trainer.train``, the quantized kernel's chunk-merge entry
in ``hist_cuda``) on the CPU, against the port's in-core fit and the JAX
package's out-of-core fit, at small sizes (4,000 rows x 8 features,
1,024-row chunks).

Tolerance: bitwise everywhere. Every ``BoosterArrays`` array of a
streamed fit equals the in-core quantized fit's (q16 and q8, histogram
subtraction off and on, uint8 and uint16 ids) and the JAX package's
streamed fit's (q8, L2 labels, its native histogram formulation, EFB off:
at q8 and 4,000 rows every bin-axis partial sum is an integer below 2^24
times a power of two, exact in float32, so no summation order moves a
bit). The sums entry's chunk-by-chunk plain version equals one pass and
``level_histogram_quant_reference``, bit for bit.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch.core import env, faults
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.faults import FaultInjected
from mmlspark_tpu_torch.core.logging_utils import SINK, reset_warn_once
from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
from mmlspark_tpu_torch.models.gbdt import ooc
from mmlspark_tpu_torch.models.gbdt import trainer as T
from mmlspark_tpu_torch.models.gbdt.estimators import LightGBMRegressor
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.ingest import (ChunkStore, SpillCorrupt,
                                           SpillWriter, binned_ingest_dtype)

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
PORT_KNOBS = ("MMLSPARK_TORCH_OOC", "MMLSPARK_TORCH_GROW_POLICY", "MMLSPARK_TORCH_SPILL_VERIFY",
              T.HIST_QUANT_ENV, T.HIST_SUB_ENV)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in PORT_KNOBS + ("MMLSPARK_TPU_OOC", "MMLSPARK_TPU_OOC_ROWS",
                              "MMLSPARK_TPU_GROW_POLICY",
                              "MMLSPARK_TPU_HIST_SUB",
                              "MMLSPARK_TPU_SPILL_VERIFY",
                              "MMLSPARK_TPU_PALLAS_HIST"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MMLSPARK_TORCH_EFB", "off")
    monkeypatch.setattr(T, "OOC_CHUNK_ROWS", 1024)
    # the JAX side: its native (integer) histograms, q8, no bundles
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "native")
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC_CHUNK_ROWS", "1024")
    faults.reset()
    jax_faults.reset()
    env.reset_warnings()
    reset_warn_once()
    SINK.drain()
    yield
    faults.reset()
    jax_faults.reset()


def _knobs(monkeypatch, quant, sub="0", ooc_mode=None):
    monkeypatch.setenv(T.HIST_QUANT_ENV, quant)
    monkeypatch.setenv(T.HIST_SUB_ENV, sub)
    if ooc_mode is not None:
        monkeypatch.setenv("MMLSPARK_TORCH_OOC", ooc_mode)


def _data(n=4000, f=8, seed=42):
    """The JAX package's OOC test data: normal columns, column 3 of five
    integer values, an L2 label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 3] = rng.integers(0, 5, size=n)
    y = x[:, 0] * 2 + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y


def _cfg(max_bin=63, **kw):
    return dict(dict(objective="regression", num_iterations=6, max_depth=4,
                     num_leaves=14, learning_rate=0.2, max_bin=max_bin), **kw)


def _binned(x, max_bin):
    mapper = BinMapper.fit_streaming(iter([x[:1777], x[1777:3200],
                                           x[3200:]]), max_bin=max_bin)
    return (mapper.transform(x, binned_ingest_dtype(max_bin)),
            mapper.bin_upper_values(max_bin))


def _same(a, b, init_score=True):
    for name in ARRAYS:
        want, got = getattr(a, name), getattr(b, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if init_score:
        assert a.init_score == b.init_score


def _fit_both(monkeypatch, binned, y, cfg, bin_upper=None, **kw):
    """(in-core fit, streamed fit) of the port through ``train``."""
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    r_in = T.train(binned, y, cfg, bin_upper=bin_upper, device="cpu", **kw)
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "on")
    r_ooc = T.train(binned, y, cfg, bin_upper=bin_upper, device="cpu", **kw)
    return r_in, r_ooc


# --- the streamed fit against the in-core fit -------------------------------

@pytest.mark.parametrize("max_bin", [63, 1023])
@pytest.mark.parametrize("sub", ["0", "1"])
@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_ooc_trees_bitwise_in_core(monkeypatch, quant, sub, max_bin):
    """Bitwise: ``train`` streamed (4 chunks) and in-core on the same
    plane; uint8 ids at max_bin 63, uint16 at 1,023."""
    _knobs(monkeypatch, quant, sub)
    x, y = _data()
    binned, upper = _binned(x, max_bin)
    cfg = T.TrainConfig(**_cfg(max_bin))
    r_in, r_ooc = _fit_both(monkeypatch, binned, y, cfg, upper)
    assert r_in.hist_stats["ooc"] is False
    assert r_in.hist_stats["ooc_reason"] == "MMLSPARK_TORCH_OOC=off"
    st = r_ooc.hist_stats
    assert st["ooc"] is True and st["ooc_reason"] is None
    assert (st["chunk_rows"], st["n_chunks"]) == (1024, 4)
    assert (st["hist_quant"], st["hist_subtract"]) == (quant, sub == "1")
    # the key an in-core fit records too
    assert st["subtract"] == r_in.hist_stats["subtract"] == (sub == "1")
    # 6 trees x 4 levels x 4 chunks through the sums entry
    assert r_ooc.step_stats["ooc"]["sums_calls"] == 96
    assert (r_in.booster.split_feature >= 0).sum() >= 30
    _same(r_in.booster, r_ooc.booster)


def test_ooc_binary_weighted_warm_start_bitwise_in_core(monkeypatch):
    """Bitwise: a weighted binary fit continued from an initial model
    (``init_model`` + ``init_raw``), streamed and in-core, with
    ``path_smooth``, ``lambda_l1`` and ``max_delta_step`` on."""
    _knobs(monkeypatch, "q16", "1")
    x, y = _data(seed=3)
    yb = (y > 0).astype(np.float64)
    w = np.random.default_rng(4).uniform(0.5, 2.0, size=len(y))
    binned, upper = _binned(x, 63)
    cfg = T.TrainConfig(**_cfg(objective="binary", path_smooth=2.0,
                               lambda_l1=0.5, max_delta_step=0.8))
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    init = T.train(binned, yb, cfg, weights=w, bin_upper=upper,
                   device="cpu").booster
    raw = T.warm_start_scores(init, x, device="cpu")
    r_in, r_ooc = _fit_both(monkeypatch, binned, yb, cfg, upper, weights=w,
                            init_model=init, init_raw=raw)
    assert r_ooc.hist_stats["ooc"] is True
    assert r_ooc.booster.num_trees == 12
    _same(r_in.booster, r_ooc.booster)


def test_quant_off_is_promoted_to_q16_with_one_warning(monkeypatch, caplog):
    _knobs(monkeypatch, "off")
    x, y = _data(n=2500)
    binned, upper = _binned(x, 63)
    cfg = T.TrainConfig(**_cfg(num_iterations=2))
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "on")
    fits = [T.train(binned, y, cfg, device="cpu") for _ in range(2)]
    assert [f.hist_stats["hist_quant"] for f in fits] == ["q16", "q16"]
    assert sum("quantizes histograms (q16)" in r.getMessage()
               for r in caplog.records) == 1
    monkeypatch.setenv(T.HIST_QUANT_ENV, "q16")
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    _same(T.train(binned, y, cfg, device="cpu").booster, fits[0].booster)


# --- the streamed fit against the JAX package's ---------------------------

@pytest.mark.parametrize("sub", ["0", "1"])
def test_ooc_trees_bitwise_the_reference(monkeypatch, sub):
    """Bitwise: the port's streamed fit and the JAX package's streamed
    fit (``train`` with ``MMLSPARK_*_OOC=on``) on q8 with L2 labels, the
    JAX side on its native histograms."""
    _knobs(monkeypatch, "q8", sub, "on")
    monkeypatch.setenv("MMLSPARK_TPU_HIST_SUB", sub)
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "on")
    x, y = _data()
    binned, upper = _binned(x, 63)
    cfg = _cfg()
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg), bin_upper=upper)
    pr = T.train(binned, y, T.TrainConfig(**cfg), bin_upper=upper,
                 device="cpu")
    assert jr.hist_stats["ooc"] is True and pr.hist_stats["ooc"] is True
    for key in ("hist_quant", "n_chunks", "chunk_rows", "hist_subtract",
                "efb_bundles", "spill_verify", "spill_repairs"):
        assert pr.hist_stats[key] == jr.hist_stats[key], key
    assert set(jr.hist_stats) <= set(pr.hist_stats)
    _same(jr.booster, pr.booster)


def test_train_ooc_from_a_written_spill_is_the_reference(monkeypatch,
                                                         tmp_path):
    """Bitwise: ``train_ooc`` over a spill written chunk by chunk (uneven
    chunks, ``fit_streaming`` edges, chunk-store labels), the port's and
    the JAX package's, each reading the other's spill."""
    from mmlspark_tpu.models.gbdt import ooc as jax_ooc
    from mmlspark_tpu.ops import ingest as jax_ingest
    _knobs(monkeypatch, "q8")
    x, y = _data(n=3000, f=5)
    mapper = BinMapper.fit_streaming(iter([x[:1300], x[1300:]]), max_bin=32)
    writer = SpillWriter(str(tmp_path / "spill"), dtype=np.uint8)
    labels = ChunkStore(str(tmp_path / "labels"), "y")
    for i, (s, e) in enumerate(((0, 1100), (1100, 2150), (2150, 3000))):
        writer.append(mapper.transform(x[s:e]))
        labels.put(i, y[s:e].astype(np.float32))
    spill = writer.finalize()
    cfg = dict(objective="regression", num_iterations=3, max_depth=3,
               max_bin=32)
    pr = ooc.train_ooc(spill, labels, T.TrainConfig(**cfg),
                       work_dir=str(tmp_path / "w1"), device="cpu")
    jr = jax_ooc.train_ooc(
        jax_ingest.SpillReader(str(tmp_path / "spill")),
        jax_ingest.ChunkStore(str(tmp_path / "labels"), "y"),
        jax_trainer.TrainConfig(**cfg), work_dir=str(tmp_path / "w2"))
    assert pr.hist_stats["n_chunks"] == 3
    _same(jr.booster, pr.booster)


# --- chunk stores, base scores, refusals --------------------------------------

def test_chunk_store_labels_and_weights_match_arrays(monkeypatch, tmp_path):
    """Bitwise: labels and weights as chunk stores give the trees of full
    arrays. The base score is then the weighted mean summed chunk by
    chunk in float64 (the reference's), which may differ from the one
    pass's in its last float64 bits; the carry starts from its float32,
    which is the same."""
    _knobs(monkeypatch, "q16", "1")
    x, y = _data(n=3000, f=5)
    w = np.random.default_rng(1).uniform(0.5, 1.5, size=len(y))
    mapper = BinMapper.fit_streaming(iter([x[:1300], x[1300:]]), max_bin=32)
    writer = SpillWriter(str(tmp_path / "spill"), dtype=np.uint8)
    labels = ChunkStore(str(tmp_path / "labels"), "y")
    weights = ChunkStore(str(tmp_path / "labels"), "w")
    for i, (s, e) in enumerate(((0, 1100), (1100, 2150), (2150, 3000))):
        writer.append(mapper.transform(x[s:e]))
        labels.put(i, y[s:e].astype(np.float32))
        weights.put(i, w[s:e].astype(np.float32))
    spill = writer.finalize()
    cfg = T.TrainConfig(objective="regression", num_iterations=3,
                        max_depth=3, max_bin=32)
    r_store = ooc.train_ooc(spill, labels, cfg, weights=weights,
                            work_dir=str(tmp_path / "w1"), device="cpu")
    r_array = ooc.train_ooc(spill, y, cfg, weights=w,
                            work_dir=str(tmp_path / "w2"), device="cpu")
    assert r_store.hist_stats["n_chunks"] == 3
    _same(r_store.booster, r_array.booster, init_score=False)
    assert np.float32(r_store.booster.init_score) == \
        np.float32(r_array.booster.init_score)
    # and the in-core fit of the same rows
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    full = np.concatenate([spill.read(i) for i in range(3)])
    _same(T.train(full, y, cfg, weights=w, device="cpu").booster,
          r_array.booster)


def test_unsupported_configs_and_median_objectives_raise(monkeypatch,
                                                         tmp_path):
    _knobs(monkeypatch, "q16")
    x, y = _data(n=1200, f=4)
    mapper = BinMapper.fit(x, max_bin=32)
    writer = SpillWriter(str(tmp_path / "spill"), dtype=np.uint8)
    labels = ChunkStore(str(tmp_path / "labels"), "y")
    for i, (s, e) in enumerate(((0, 700), (700, 1200))):
        writer.append(mapper.transform(x[s:e]))
        labels.put(i, y[s:e].astype(np.float32))
    spill = writer.finalize()
    bad = T.TrainConfig(objective="regression", num_iterations=2,
                        max_bin=32, feature_fraction=0.5)
    with pytest.raises(ValueError, match="cannot stream this fit: "
                                         "feature sampling"):
        ooc.train_ooc(spill, y, bad, device="cpu")
    for name in ("regression_l1", "quantile"):
        med = T.TrainConfig(objective=name, num_iterations=2, max_bin=32)
        with pytest.raises(ValueError, match="median"):
            ooc.train_ooc(spill, labels, med, device="cpu")
        # full array labels stream under the same objective
        r = ooc.train_ooc(spill, y, med, device="cpu")
        assert r.booster.num_trees == 2
    with pytest.raises(ValueError, match="needs labels"):
        ooc.train_ooc(spill, None, bad.__class__(max_bin=32), device="cpu")
    with pytest.raises(ValueError, match="warm start needs init_raw"):
        ooc.train_ooc(spill, y, T.TrainConfig(max_bin=32, num_iterations=1),
                      init_model=r.booster, device="cpu")


@pytest.mark.parametrize("max_bin", [63, 1023])
def test_tensor_rows_stream_as_their_numpy_rows(monkeypatch, max_bin):
    """Bitwise: ``train`` given the bin ids as a tensor (uint8, or uint16
    past 256 bins) streams them as it streams the numpy rows."""
    _knobs(monkeypatch, "q16", ooc_mode="on")
    x, y = _data(n=2500, f=4)
    binned, upper = _binned(x, max_bin)
    cfg = T.TrainConfig(**_cfg(max_bin, num_iterations=2))
    rows = (torch.from_numpy(binned) if binned.dtype == np.uint8 else
            torch.from_numpy(binned.view(np.int16)).view(torch.uint16))
    from_tensor = T.train(rows, y, cfg, bin_upper=upper, device="cpu")
    assert from_tensor.hist_stats["ooc"] is True
    _same(T.train(binned, y, cfg, bin_upper=upper, device="cpu").booster,
          from_tensor.booster)


def test_bin_ids_out_of_range_raise(monkeypatch):
    _knobs(monkeypatch, "q16", ooc_mode="on")
    x, y = _data(n=1500, f=4)
    binned = BinMapper.fit(x, max_bin=63).transform(x)
    with pytest.raises(ValueError, match="bin ids must lie"):
        T.train(binned, y, T.TrainConfig(max_bin=16, num_iterations=1),
                device="cpu")


# --- the dispatch ---------------------------------------------------------------

def test_auto_threshold_on_and_off(monkeypatch):
    """auto streams exactly when the in-core fit's estimated bytes
    (``in_core_bytes``: the rows and the widest level's histogram
    planes) exceed the device's free bytes; on the CPU (no bound) it
    stays in-core."""
    _knobs(monkeypatch, "q16")
    x, y = _data(n=2000, f=4)
    binned = BinMapper.fit(x, max_bin=32).transform(x)
    cfg = T.TrainConfig(objective="regression", num_iterations=2,
                        max_depth=3, max_bin=32)
    assert T.device_free_bytes(torch.device("cpu")) is None
    small = T.train(binned, y, cfg, device="cpu")
    assert small.hist_stats["ooc"] is False
    assert small.hist_stats["ooc_reason"] == (
        "auto: the in-core fit fits in device memory")
    # the rows' bytes and the widest level's histogram planes (max_depth
    # 3: 4 nodes)
    need = T.in_core_bytes(2000, 4, 32, 4)
    assert need == 2000 * (2 * 4 + T.IN_CORE_ROW_BYTES) \
        + 4 * 4 * 32 * T.HIST_CELL_BYTES
    assert T.in_core_bytes(2000, 4, 1023) == 2000 * (
        4 * 4 + T.IN_CORE_ROW_BYTES) + 4 * 1023 * T.HIST_CELL_BYTES
    assert T.in_core_bytes(2000, 4, 70_000, 4) == 2000 * (
        8 * 4 + T.IN_CORE_ROW_BYTES) + 4 * 4 * 70_000 * T.HIST_CELL_BYTES
    # a device with exactly the bytes the fit needs keeps it in-core
    monkeypatch.setattr(T, "device_free_bytes", lambda dev: need)
    fits = T.train(binned, y, cfg, device="cpu")
    assert fits.hist_stats["ooc"] is False
    # one byte fewer and auto streams
    monkeypatch.setattr(T, "device_free_bytes", lambda dev: need - 1)
    big = T.train(binned, y, cfg, device="cpu")
    assert big.hist_stats["ooc"] is True
    assert big.hist_stats["n_chunks"] == 2
    _same(small.booster, big.booster)
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    off = T.train(binned, y, cfg, device="cpu")
    assert off.hist_stats["ooc_reason"] == "MMLSPARK_TORCH_OOC=off"
    # a bad value warns once and runs auto
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "sometimes")
    with pytest.warns(UserWarning, match="auto|off|on"):
        assert T.train(binned, y, cfg, device="cpu").hist_stats["ooc"]


def test_on_downgrades_an_unsupported_fit_with_one_warning(monkeypatch):
    _knobs(monkeypatch, "q16", ooc_mode="on")
    x, y = _data(n=1500, f=4)
    binned = BinMapper.fit(x, max_bin=32).transform(x)
    cfg = T.TrainConfig(objective="regression", num_iterations=2,
                        max_depth=3, max_bin=32, feature_fraction=0.5)
    with pytest.warns(UserWarning, match="cannot stream"):
        r = T.train(binned, y, cfg, device="cpu")
    assert r.hist_stats["ooc"] is False
    assert r.hist_stats["ooc_reason"] == "feature sampling"
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        T.train(binned, y, cfg, device="cpu")
    assert not [w for w in rec if "cannot stream" in str(w.message)]
    # validation sets keep a fit in-core, with the reference's reason
    r = T.train(binned, y, T.TrainConfig(max_bin=32, num_iterations=1),
                valid_sets=[(binned[:100], y[:100], None)], device="cpu")
    assert r.hist_stats["ooc_reason"] == "validation sets / early stopping"


def _reason_cases():
    """(port config, JAX config, _ooc_supported keyword arguments,
    environment) per clause."""
    base = dict(objective="regression", max_bin=32)
    return [
        ("leafwise", {}, {}, "GROW_POLICY", "leafwise"),
        ("voting", {"tree_learner": "voting"}, {}, None, None),
        ("feature", {"tree_learner": "feature"}, {}, None, None),
        ("dart", {"boosting_type": "dart"}, {}, None, None),
        ("goss", {"boosting_type": "goss"}, {}, None, None),
        ("rf", {"boosting_type": "rf", "bagging_freq": 1,
                "bagging_fraction": 0.5}, {}, None, None),
        ("custom", {}, {"has_custom": True}, None, None),
        ("multiclass", {"objective": "multiclass", "num_class": 3},
         {"k": 3}, None, None),
        ("lambdarank", {"objective": "lambdarank"}, {}, None, None),
        ("groups", {}, {"has_groups": True}, None, None),
        ("valid", {}, {"has_valid": True}, None, None),
        ("early_stopping", {"early_stopping_round": 3}, {}, None, None),
        ("bagging", {"bagging_freq": 1, "bagging_fraction": 0.5}, {}, None,
         None),
        ("pos_neg", {"objective": "binary", "pos_bagging_fraction": 0.5},
         {}, None, None),
        ("feature_fraction", {"feature_fraction": 0.5}, {}, None, None),
        ("by_node", {"feature_fraction_by_node": 0.5}, {}, None, None),
        ("extra_trees", {"extra_trees": True}, {}, None, None),
        ("categorical", {"categorical_features": (1,)}, {}, None, None),
        ("monotone", {"monotone_constraints": (1, 0)}, {}, None, None),
        ("supported", {}, {}, None, None),
    ], base


@pytest.mark.parametrize("case", [c[0] for c in _reason_cases()[0]])
def test_ooc_supported_reasons_are_the_reference(monkeypatch, case):
    """Every clause of ``_ooc_supported`` gives the JAX package's reason,
    word for word; a supported fit gives None on both sides (the JAX side
    on its native formulation; ROADMAP C24: the port has no such
    clause). The reference's mesh clause has no counterpart."""
    cases, base = _reason_cases()
    _, over, kw, knob, value = next(c for c in cases if c[0] == case)
    if knob is not None:
        monkeypatch.setenv(f"MMLSPARK_TORCH_{knob}", value)
        monkeypatch.setenv(f"MMLSPARK_TPU_{knob}", value)
    cfg = dict(base, **over)
    port = T._ooc_supported(T.TrainConfig(**cfg), **kw)
    ref = jax_trainer._ooc_supported(
        jax_trainer.TrainConfig(**cfg), None, k=kw.get("k", 1),
        has_valid=kw.get("has_valid", False),
        has_custom=kw.get("has_custom", False),
        has_groups=kw.get("has_groups", False), total_bins=32)
    assert port == ref
    assert (port is None) == (case == "supported")


def test_ooc_supported_c24_the_native_clause(monkeypatch):
    """The reference refuses to stream off its native formulation; the
    port's quantized kernel always sums integers, so it has no such
    clause (ROADMAP C24)."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    cfg = dict(objective="regression", max_bin=32)
    assert "native histogram kernel" in jax_trainer._ooc_supported(
        jax_trainer.TrainConfig(**cfg), None, k=1, has_valid=False,
        has_custom=False, has_groups=False, total_bins=32)
    assert T._ooc_supported(T.TrainConfig(**cfg)) is None


def test_disk_full_falls_back_in_core(monkeypatch, caplog):
    """A ``DiskFull`` from the spill: one warning, the fit trains in-core
    (bitwise the in-core fit) and says why."""
    _knobs(monkeypatch, "q16", ooc_mode="on")
    x, y = _data(n=2500, f=4)
    binned = BinMapper.fit(x, max_bin=32).transform(x)
    cfg = T.TrainConfig(objective="regression", num_iterations=2,
                        max_depth=3, max_bin=32)
    for nth in (1, 5):       # the spill's first chunk; a store's write
        with faults.injected("io.disk_full", "raise", nth=nth):
            r = T.train(binned, y, cfg, device="cpu")
        assert r.hist_stats["ooc"] is False
        assert r.hist_stats["ooc_reason"] == \
            "io.disk_full: spill write failed"
    assert sum("full disk" in rec.getMessage()
               for rec in caplog.records) == 1
    monkeypatch.setenv("MMLSPARK_TORCH_OOC", "off")
    _same(T.train(binned, y, cfg, device="cpu").booster, r.booster)


def _flip(payload):
    b = bytearray(payload)
    b[len(b) // 2] ^= 0x10
    return bytes(b)


def test_corrupt_chunk_is_repaired_from_source_bitwise(monkeypatch,
                                                       caplog):
    """An armed ``spill.read`` corrupt on a binned chunk's first read (hit
    5: the first tree's amax pass reads the 4 carry chunks first) is
    caught by its crc32 and the chunk re-derived from the caller's
    matrix: one repair, the trees unchanged."""
    _knobs(monkeypatch, "q16", "1", "on")
    x, y = _data()
    binned, upper = _binned(x, 63)
    cfg = T.TrainConfig(**_cfg(num_iterations=3))
    clean = T.train(binned, y, cfg, device="cpu")
    with faults.injected("spill.read", "corrupt", nth=5, count=1,
                         corrupt=_flip):
        fixed = T.train(binned, y, cfg, device="cpu")
        assert faults.fired("spill.read") == 1
    assert fixed.hist_stats["spill_repairs"] == 1
    assert clean.hist_stats["spill_repairs"] == 0
    assert any("re-deriving" in r.getMessage() for r in caplog.records)
    _same(clean.booster, fixed.booster)


def test_corrupt_chunk_without_source_names_the_artifact(monkeypatch,
                                                         tmp_path):
    _knobs(monkeypatch, "q16")
    x, y = _data(n=2100, f=4)
    mapper = BinMapper.fit(x, max_bin=32)
    writer = SpillWriter(str(tmp_path / "spill"), dtype=np.uint8)
    for s in range(0, 2100, 1024):
        writer.append(mapper.transform(x[s:s + 1024]))
    spill = writer.finalize()
    cfg = T.TrainConfig(objective="regression", num_iterations=1,
                        max_bin=32)
    # hit 4: binned chunk 0 (after 3 carry reads); hit 2: carry chunk 1
    for nth, match in ((4, "spill chunk 0"),
                       (2, "chunk store 'carry' chunk 1")):
        with faults.injected("spill.read", "corrupt", nth=nth, count=1,
                             corrupt=_flip):
            with pytest.raises(SpillCorrupt, match=match):
                ooc.train_ooc(spill, y, cfg, device="cpu")


def test_kill_and_resume_mid_ensemble_through_checkpoints(monkeypatch,
                                                          tmp_path):
    """A streamed estimator fit killed mid-ensemble resumes through its
    segment checkpoints and reproduces the uninterrupted streamed fit
    bitwise (each segment streams)."""
    _knobs(monkeypatch, "q16", ooc_mode="on")
    streamed = []
    real = ooc.train_from_binned
    monkeypatch.setattr(ooc, "train_from_binned",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))
    x, y = _data(n=2500, f=4)
    df = DataFrame({"features": x, "label": y})
    kw = dict(numIterations=9, numLeaves=8, maxBin=32, checkpointInterval=3)

    def fit(ckdir):
        return LightGBMRegressor(checkpointDir=str(ckdir), **kw) \
            .set_device("cpu").fit(df)

    ref = fit(tmp_path / "a")
    assert len(streamed) == 3
    with faults.injected("gbdt.train_step", "raise", nth=7):
        with pytest.raises(FaultInjected):
            fit(tmp_path / "b")
    names = sorted(n for n in os.listdir(tmp_path / "b")
                   if n.endswith(".txt"))
    assert names == ["checkpoint_3.txt", "checkpoint_6.txt"]
    resumed = fit(tmp_path / "b")
    assert resumed.booster.num_trees == 9
    assert resumed.get_model_string() == ref.get_model_string()
    np.testing.assert_array_equal(
        np.asarray(ref.transform(df)["prediction"]),
        np.asarray(resumed.transform(df)["prediction"]))


# --- the sums entry ----------------------------------------------------------

@pytest.mark.parametrize("b,dtype", [(63, torch.uint8), (1023, torch.uint16)])
@pytest.mark.parametrize("qdt", [torch.int16, torch.int8])
def test_sums_entry_chunk_by_chunk_is_one_pass(b, dtype, qdt):
    """Bitwise: the plain sums entry, chunk by chunk into one
    accumulator, equals one pass over every row, and its dequantization
    equals ``level_histogram_quant_reference``'s histogram."""
    rng = np.random.default_rng(5)
    n, f, width = 3000, 5, 4
    ids = rng.integers(0, b, size=(n, f))
    binned = (torch.from_numpy(ids.astype(np.uint8)) if dtype == torch.uint8
              else torch.from_numpy(ids.astype(np.int16)).view(torch.uint16))
    hi = 120 if qdt == torch.int8 else 32000
    gq = torch.from_numpy(rng.integers(-hi, hi + 1, size=n)).to(qdt)
    hq = torch.from_numpy(rng.integers(0, hi + 1, size=n)).to(qdt)
    live = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32))
    local = torch.from_numpy(rng.integers(0, width, size=n))
    acc = torch.zeros((width, f, b, 3), dtype=torch.int64)
    for s in (0, 1000, 1001, 2500):
        e = {0: 1000, 1000: 1001, 1001: 2500, 2500: n}[s]
        out = H.level_histogram_quant_sums(
            binned[s:e].contiguous(), gq[s:e], hq[s:e], live[s:e],
            local[s:e], width, f, b, acc)
        assert out is acc
    one = H.level_histogram_quant_sums_reference(binned, gq, hq, live,
                                                 local, width, f, b)
    assert torch.equal(acc, one)
    ginv, hinv = torch.tensor(2.0 ** -9), torch.tensor(2.0 ** -13)
    hist = H.dequantize_sums(acc, ginv, hinv)
    assert torch.equal(hist, H.level_histogram_quant_reference(
        binned, gq, hq, live, local, width, f, b, ginv, hinv))
    assert torch.equal(hist, H.level_histogram_quant(
        binned, gq, hq, live, local, width, f, b, ginv, hinv))


def test_sums_entry_refusals():
    n, f, b = 8, 2, 4
    binned = torch.zeros((n, f), dtype=torch.uint8)
    q = torch.zeros(n, dtype=torch.int16)
    live, local = torch.ones(n), torch.zeros(n, dtype=torch.int64)
    for acc in (torch.zeros((1, f, b, 3), dtype=torch.int32),
                torch.zeros((2, f, b, 3), dtype=torch.int64),
                torch.zeros((1, f, b, 6), dtype=torch.int64)[..., ::2]):
        with pytest.raises(ValueError, match="acc must be"):
            H.level_histogram_quant_sums(binned, q, q, live, local, 1, f, b,
                                         acc)
    with pytest.raises(ValueError, match="acc must be"):
        H.dequantize_sums(torch.zeros((1, f, b, 2), dtype=torch.int64),
                          1.0, 1.0)
    with pytest.raises(ValueError, match="scalars"):
        H.dequantize_sums(torch.zeros((1, f, b, 3), dtype=torch.int64),
                          torch.ones(2), 1.0)

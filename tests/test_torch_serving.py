"""The port's binned serving plane (``serving_binned_plan``, the binned
scorer, ``ServingServer`` / ``ContinuousServingServer``) against the
JAX package's on the same seeded numpy inputs, on the CPU
(``set_device("cpu")``).

The models are fitted in JAX (histogram formulation pinned to
``per_feature``, EFB and out-of-core off, as
``test_torch_gbdt_train`` pins them) and carried over with
``convert.model_from_jax``. Everything is held bit for bit:

  - ``supports_binned``, ``zero_premap_mode``, ``derive_binning`` and
    ``DerivedBinning.transform`` (refusals included) equal JAX's;
  - the port's plan equals the JAX plan (``bin_rows``, ``score`` at
    every rung, ``finish``) for a trained and an imported model, with
    autocast off and bf16;
  - served replies equal ``transform`` (JSON carries a float64 repr
    exactly), and the JAX model's ``transform`` in example 01's flow.

The overload tests (503 + Retry-After, deadlines, connection cap,
keep-alive timeout, the continuous server's in-flight bound) use a slow
Transformer where the JAX tests arm a fault point.
"""

import dataclasses
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch import io as port_io
from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.core.device import DeviceUnavailable
from mmlspark_tpu_torch.core.pipeline import PipelineStage, Transformer
from mmlspark_tpu_torch.io.serving import (ContinuousServingServer,
                                           FleetClient, ServingFleet,
                                           ServingServer, _Pending,
                                           serve_continuous,
                                           serve_distributed)
from mmlspark_tpu_torch.models.gbdt import estimators
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax
from mmlspark_tpu_torch.parallel.inference import bucket_ladder

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

pytestmark = pytest.mark.serving_smoke

N, F = 3000, 28  # HIGGS-shaped feature count, small N
JAX_PINS = {"MMLSPARK_TPU_HIST_FORMULATION": "per_feature",
            "MMLSPARK_TPU_EFB": "off", "MMLSPARK_TPU_OOC": "off"}
SERVE_ENVS = (env.SERVE_BINNED, env.SERVE_BUCKETS, env.SERVE_MODEL_QUEUE,
              env.SERVE_WARM_MODELS, env.SERVE_TENANT_RATE,
              env.SERVE_TENANT_BURST, env.INFER_AUTOCAST,
              "MMLSPARK_TPU_INFER_AUTOCAST")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in SERVE_ENVS:
        monkeypatch.delenv(name, raising=False)


def _make_data(rng, n=N):
    x = rng.normal(size=(n, F))
    y = (x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


def _jax_fit(kind, x, y, **params):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in JAX_PINS.items():
            mp.setenv(k, v)
        return getattr(jax_est, kind)(**params).fit(
            JaxFrame({"features": x, "label": y}))


def _to_port(ref):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    return model_from_jax(type(ref).__name__, state,
                          ref.simple_param_values()).set_device("cpu")


@pytest.fixture(scope="module")
def higgs():
    """(JAX model, port model on the CPU, rows): the JAX serving tests'
    model, with a few NaNs so the missing bin is served too."""
    x, y = _make_data(np.random.default_rng(7))
    x[np.random.default_rng(8).random(x.shape) < 0.01] = np.nan
    ref = _jax_fit("LightGBMClassifier", x, y, numIterations=15,
                   numLeaves=15, maxBin=63)
    return ref, _to_port(ref), x


def _post(url, payload, timeout=30, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _base(server):
    return f"http://{server.host}:{server.port}"


def _score_rows(server, rows, threads=8):
    """Concurrent single-row POSTs (``__id__``-correlated) -> replies by
    row."""
    replies = [None] * len(rows)
    errors = []

    def worker(idx):
        try:
            replies[idx] = _post(server.url, {
                "features": [None if np.isnan(v) else float(v)
                             for v in rows[idx]], "__id__": idx})
        except Exception as e:  # pragma: no cover - fails the test below
            errors.append((idx, e))

    pending = list(range(len(rows)))
    while pending:
        chunk, pending = pending[:threads], pending[threads:]
        ts = [threading.Thread(target=worker, args=(i,)) for i in chunk]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
    assert not errors, errors
    return replies


def _assert_replies_equal(frame_out, replies):
    """== on floats is the bitwise contract: JSON round-trips a float64
    repr exactly."""
    raw = frame_out["rawPrediction"]
    prob = frame_out["probability"]
    pred = frame_out["prediction"]
    for i, reply in enumerate(replies):
        assert reply["id"] == i
        assert reply["prediction"] == float(pred[i])
        assert reply["rawPrediction"] == [float(v) for v in raw[i]]
        assert reply["probability"] == [float(v) for v in prob[i]]


# --- the booster: eligibility, derived binning, the scorer ---------------------

DEPTH, NF = 3, 4


def _synthetic(decision, seed=0, tb_valid=True):
    """(JAX booster, port booster) with the same arrays: 6 full trees of
    depth 3 over 4 features, thresholds on a small grid holding 0.0,
    decision bits from ``decision`` (None, an int for every node, or a
    list cycled over nodes; bit 0 makes a node categorical)."""
    rng = np.random.default_rng(seed)
    t, m = 6, 2 ** (DEPTH + 1) - 1
    internal = np.zeros((t, m), bool)
    internal[:, :2 ** DEPTH - 1] = True
    sf = np.where(internal, rng.integers(0, NF, (t, m)), -1).astype(np.int32)
    grid = np.array([-1.0, -0.5, 0.0, 0.25, 1.5])
    tv = np.where(internal, grid[rng.integers(0, len(grid), (t, m))], np.inf)
    tb = np.where(internal, rng.integers(1, 5, (t, m)) if tb_valid else -1,
                  0).astype(np.int32)
    arrays = dict(split_feature=sf, threshold_bin=tb, threshold_value=tv,
                  node_value=rng.normal(size=(t, m)).astype(np.float32),
                  count=np.full((t, m), 10.0, np.float32),
                  tree_weights=np.ones(t, np.float32), max_depth=DEPTH,
                  num_features=NF)
    if decision is not None:
        codes = np.resize(np.atleast_1d(decision), t * m).reshape(t, m)
        arrays["decision_type"] = np.where(internal, codes, 0).astype(np.int8)
        arrays["cat_bitset"] = np.full((t, m, 1), 0b1010, np.uint32)
    return JaxBooster(**arrays), BoosterArrays(**arrays)


def _raw_rows(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.choice([-2.0, -1.0, -0.7, -0.5, 0.0, 0.1, 0.25, 1.0, 1.5, 3.0],
                   size=(64, NF))
    return x


DECISIONS = {
    "none": None,
    "nan_left": 10,            # default left, NaN missing (trained)
    "nan_right": 8,            # NaN missing, default right
    "zero_left": 6,            # zero-as-missing, default left
    "zero_mixed": [6, 4],      # zero-as-missing both ways
    "compare": 0,              # missing type none: NaN compares as 0.0
    "nan_mixed": [10, 8],      # NaN both ways
    "categorical": [10, 1],    # some categorical nodes
}


@pytest.mark.parametrize("case", sorted(DECISIONS))
@pytest.mark.parametrize("tb_valid", [True, False])
def test_binned_eligibility_and_derived_binning_match_jax(case, tb_valid):
    jb, pb = _synthetic(DECISIONS[case], tb_valid=tb_valid)
    assert pb.has_categorical == jb.has_categorical
    assert pb.supports_binned == jb.supports_binned
    assert pb.zero_premap_mode == jb.zero_premap_mode
    if jb.has_categorical:
        with pytest.raises(NotImplementedError):
            jb.derive_binning()
        with pytest.raises(NotImplementedError, match="categorical"):
            pb.derive_binning()
        return
    jbin, jder = jb.derive_binning()
    pbin, pder = pb.derive_binning()
    assert len(pbin.thresholds) == len(jbin.thresholds)
    for a, b in zip(pbin.thresholds, jbin.thresholds):
        np.testing.assert_array_equal(a, b)
    for name in ("nan_bin", "zero_bin"):
        np.testing.assert_array_equal(getattr(pbin, name),
                                      getattr(jbin, name), err_msg=name)
    assert pbin.num_bins == jbin.num_bins and pbin.dtype == jbin.dtype
    np.testing.assert_array_equal(pder.threshold_bin, jder.threshold_bin)
    assert pder.supports_binned and jder.supports_binned
    x = _raw_rows()
    with_nan = x.copy()
    with_nan[::5, 1] = np.nan
    for rows in (x, with_nan):
        try:
            want = jbin.transform(rows)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pbin.transform(rows)
            # the same refusal, naming predict where JAX names predict_fn
            assert str(got.value) == str(e).replace("predict_fn", "predict")
            continue
        got = pbin.transform(rows)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("autocast", ["off", "bf16"])
def test_scorers_round_each_tree_add_as_xla_fma(higgs, autocast):
    """Tree weights other than 1 (the case of ROADMAP C9): XLA contracts
    the scan's ``acc + leaf * weight`` into one fused multiply-add; the
    port's binned scorer, ``predict_binned`` and ``predict`` round it
    the same way."""
    ref, _, x = higgs
    rng = np.random.default_rng(3)
    jb = dataclasses.replace(
        ref.booster, init_score=0.123456789,
        tree_weights=rng.uniform(0.3, 1.7, ref.booster.num_trees)
        .astype(np.float32))
    pb = BoosterArrays.from_state_dict(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in jb.state_dict().items()})
    rows = x[:64]
    bins = ref.bin_mapper.transform(rows).astype(np.uint8)
    want = np.asarray(jb.predict_binned_jit(autocast)(bins))
    got = pb.predict_binned_scorer(autocast, "cpu")(bins).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if autocast == "off":
        np.testing.assert_array_equal(
            pb.predict_binned(bins, device="cpu").numpy(), want)
        np.testing.assert_array_equal(
            pb.predict(rows, device="cpu").numpy(),
            np.asarray(jb.predict_jit()(rows)))


def test_scorer_is_cached_and_cleared(higgs):
    _, port, x = higgs
    b = port.booster
    s1 = b.predict_binned_scorer("off", "cpu")
    assert b.predict_binned_scorer("off", "cpu") is s1
    assert b.predict_binned_scorer("bf16", "cpu") is not s1
    b.clear_jit_cache()
    assert b.predict_binned_scorer("off", "cpu") is not s1
    assert b.supports_binned and b.zero_premap_mode == "none"
    with pytest.raises(ValueError, match="autocast"):
        b.predict_binned_scorer("fp8", "cpu")
    imported = BoosterArrays.load_model_string(b.save_model_string())
    with pytest.raises(ValueError, match="derive_binning"):
        imported.predict_binned_scorer("off", "cpu")


# --- the plan: the port's against JAX's ----------------------------------------

def _plans(higgs, source, autocast, monkeypatch):
    ref, port, _ = higgs
    monkeypatch.setenv(env.INFER_AUTOCAST, autocast)
    monkeypatch.setenv("MMLSPARK_TPU_INFER_AUTOCAST", autocast)
    if source == "imported":
        text = ref.get_model_string()
        ref = jax_est.LightGBMClassificationModel \
            .load_native_model_from_string(text)
        port = estimators.LightGBMClassificationModel \
            .load_native_model_from_string(text).set_device("cpu")
    return ref.serving_binned_plan(), port.serving_binned_plan()


@pytest.mark.parametrize("autocast", ["off", "bf16"])
@pytest.mark.parametrize("source", ["trained", "imported"])
def test_serving_plan_matches_jax(higgs, source, autocast, monkeypatch):
    jplan, pplan = _plans(higgs, source, autocast, monkeypatch)
    _, _, x = higgs
    assert (pplan.autocast, pplan.num_features, pplan.features_col) == \
        (jplan.autocast, jplan.num_features, jplan.features_col) == \
        (autocast, F, "features")
    assert np.dtype(pplan.ingest_dtype) == np.dtype(jplan.ingest_dtype)
    ladder = bucket_ladder(64)
    rows = x[100:100 + ladder[-1]]
    pb, jb = pplan.bin_rows(rows), jplan.bin_rows(rows)
    assert pb.dtype == jb.dtype
    np.testing.assert_array_equal(pb, jb)
    for rung in ladder:
        got = pplan.score(pb[:rung])
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        want = np.asarray(jplan.score(jb[:rung]))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(rung))
    # padding to a rung and slicing changes no bit
    padded = np.zeros_like(pb[:8])
    padded[:5] = pb[:5]
    np.testing.assert_array_equal(pplan.score(padded)[:5].numpy(),
                                  pplan.score(pb[:5]).numpy())
    raw = pplan.score(pb).numpy()
    pf, jf = pplan.finish(raw), jplan.finish(raw)
    assert list(pf) == list(jf)
    for c in jf:
        np.testing.assert_array_equal(pf[c], jf[c], err_msg=c)


def test_plan_refusals_are_binned_serving_unsupported(higgs):
    _, port, _ = higgs
    with pytest.raises(estimators.BinnedServingUnsupported,
                       match="leafPredictionCol"):
        port.copy(leafPredictionCol="leaf").set_device(
            "cpu").serving_binned_plan()
    with pytest.raises(estimators.BinnedServingUnsupported,
                       match="no fitted booster"):
        estimators.LightGBMClassificationModel().serving_binned_plan()


# --- the server: the JAX serving tests on the port -----------------------------

def test_binned_serving_bitwise_parity(higgs, monkeypatch):
    ref, port, x = higgs
    rows = x[:48]
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    with ServingServer(port, max_batch_size=8,
                       max_latency_ms=2.0) as server:
        health = _get(f"{_base(server)}/healthz")
        assert health["binned"] == {"mode": "on", "active": True,
                                    "reason": None}
        assert health["buckets"] == [1, 2, 4, 8]
        replies = _score_rows(server, rows)
        stats = _get(f"{_base(server)}/healthz")
    assert stats["served"] == len(rows) and stats["errors"] == 0
    served = server._models["default"]
    assert served.stats["generic_batches"] == 0
    assert served.stats["binned_fallbacks"] == 0
    _assert_replies_equal(port.transform(DataFrame({"features": rows})),
                          replies)
    _assert_replies_equal(ref.transform(JaxFrame({"features": rows})),
                          replies)


def test_generic_off_mode_matches_transform_too(higgs, monkeypatch):
    _, port, x = higgs
    rows = x[:16]
    monkeypatch.setenv(env.SERVE_BINNED, "off")
    with ServingServer(port, max_batch_size=4,
                       max_latency_ms=2.0) as server:
        health = _get(f"{_base(server)}/healthz")
        assert health["binned"]["active"] is False
        assert "off" in health["binned"]["reason"]
        replies = _score_rows(server, rows)
    assert server._models["default"].stats["binned_batches"] == 0
    _assert_replies_equal(port.transform(DataFrame({"features": rows})),
                          replies)


def test_imported_model_string_serves_through_its_own_plan(higgs,
                                                           monkeypatch):
    ref, _, x = higgs
    imported = estimators.LightGBMClassificationModel \
        .load_native_model_from_string(ref.get_model_string()) \
        .set_device("cpu")
    rows = x[:24]
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    with ServingServer(imported, max_batch_size=8,
                       max_latency_ms=2.0) as server:
        assert _get(f"{_base(server)}/healthz")["binned"]["active"]
        replies = _score_rows(server, rows)
    plan = imported.serving_binned_plan()
    cols = plan.finish(plan.score(plan.bin_rows(rows)).numpy())
    _assert_replies_equal(cols, replies)


class _DoubleModel(Transformer):
    def _transform(self, df):
        return df.with_column(
            "out", np.asarray(df.col("value"), np.float64) * 2)


def test_on_mode_downgrades_with_reason_for_generic_transformer(
        monkeypatch):
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    with ServingServer(_DoubleModel(), max_batch_size=4,
                       max_latency_ms=2.0) as server:
        health = _get(f"{_base(server)}/healthz")
        assert health["binned"]["active"] is False
        assert "serving_binned_plan" in health["binned"]["reason"]
        assert _post(server.url, {"value": 3.0})["out"] == 6.0


def test_bucket_ladder_holds_shapes_seen(higgs, monkeypatch):
    """1,000 requests at every batch size 1..32 score at most
    ladder-many shapes: ``shapes_seen`` is the ladder's length after
    warmup and stays there."""
    _, port, x = higgs
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    server = ServingServer(port, max_batch_size=32,
                           max_latency_ms=1.0).start()
    try:
        served = server._models["default"]
        plane = served.plane
        assert plane is not None
        assert server._ladder == [1, 2, 4, 8, 16, 32]
        assert plane.shapes_seen == len(server._ladder)
        rng = np.random.default_rng(3)
        total = size = 0
        while total < 1000:
            b = (size % 32) + 1
            size += 1
            batch = []
            for row in x[rng.integers(0, len(x), size=b)]:
                p = _Pending({"features": row.tolist()})
                p.binned = plane.bin_row(p.payload)
                assert isinstance(p.binned, np.ndarray)
                batch.append(p)
            server._score(batch, served)
            assert all(q.reply is not None for q in batch)
            total += b
        assert served.stats["binned_batches"] == size
        assert served.stats["generic_batches"] == 0
        assert plane.shapes_seen == len(server._ladder)
    finally:
        server.stop()


def test_bucket_override_and_bad_knobs(monkeypatch):
    monkeypatch.setenv(env.SERVE_BUCKETS, "3,100,0")
    server = ServingServer(_DoubleModel(), max_batch_size=16)
    try:
        assert server._ladder == [1, 3, 16]
    finally:
        server.stop()
    monkeypatch.setenv(env.SERVE_BUCKETS, "a,b")
    monkeypatch.setenv(env.SERVE_WARM_MODELS, "0")
    env.reset_warnings()
    with pytest.warns(UserWarning):
        server = ServingServer(_DoubleModel(), max_batch_size=4)
    try:
        assert server._ladder == [1, 2, 4]
        assert server._warm_capacity == 4
    finally:
        server.stop()


# --- multi-model, backpressure and the HTTP surface ----------------------------

class _ScaleModel(Transformer):
    def __init__(self, k):
        super().__init__()
        self._k = k

    def _transform(self, df):
        return df.with_column(
            "out", np.asarray(df.col("value"), np.float64) * self._k)


def test_multi_model_routing_path_payload_and_default():
    models = {"double": _ScaleModel(2.0), "triple": _ScaleModel(3.0)}
    with ServingServer(models=models, max_batch_size=4,
                       max_latency_ms=2.0) as server:
        base = _base(server)
        assert _post(server.url, {"value": 5.0})["out"] == 10.0
        assert _post(f"{base}/models/triple/score",
                     {"value": 5.0})["out"] == 15.0
        assert _post(server.url, {"value": 5.0,
                                  "__model__": "triple"})["out"] == 15.0
        for bad in (f"{base}/models/nope/score", None):
            with pytest.raises(urllib.error.HTTPError) as err:
                if bad:
                    _post(bad, {"value": 1.0})
                else:
                    _post(server.url, {"value": 1.0, "__model__": "nope"})
            assert err.value.code == 404
        listing = _get(f"{base}/models")
        assert listing["default"] == "double"
        assert set(listing["models"]) == {"double", "triple"}
        mh = _get(f"{base}/models/triple/healthz")
        assert mh["served"] >= 2
        assert mh["binned"]["active"] is False
        health = _get(f"{base}/healthz")
        assert health["served"] >= 3
        assert set(health["models"]) == {"double", "triple"}


def test_warm_cold_lru_eviction_rebuilds_planes(monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(800, 6))
    models = {}
    for name, scale in (("a", 1.0), ("b", 10.0)):
        y = x @ np.arange(1, 7, dtype=np.float64) * scale
        models[name] = estimators.LightGBMRegressor(
            numIterations=8, numLeaves=7, maxBin=31).set_device(
            "cpu").fit(DataFrame({"features": x, "label": y}))
    row = {"features": x[0].tolist()}
    expect = {name: float(m.transform(
        DataFrame({"features": x[:1]})).col("prediction")[0])
        for name, m in models.items()}
    monkeypatch.setenv(env.SERVE_WARM_MODELS, "1")
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    with ServingServer(models=models, max_batch_size=2,
                       max_latency_ms=1.0) as server:
        base = _base(server)
        # one model fits the warm set: scoring b evicts a, scoring a
        # again rebuilds its plane (and its booster's scorer)
        for name in ("a", "b", "a", "b"):
            reply = _post(f"{base}/models/{name}/score", dict(row))
            assert reply["prediction"] == expect[name]
        stats = _get(f"{base}/healthz")["models"]
        assert sum(m["evictions"] for m in stats.values()) >= 2
        assert sum(m["cold_rebuilds"] for m in stats.values()) >= 2
        assert sum(m["warm"] for m in stats.values()) == 1
        assert all(m["binned"]["mode"] == "on" for m in stats.values())
    assert "_scorers" not in models["a"].booster.__dict__


class _SlowDouble(Transformer):
    """A slow model: each batch takes ``delay_s``; ``started`` is set
    when the first batch begins."""

    def __init__(self, delay_s):
        super().__init__()
        self._delay_s = delay_s
        self.started = threading.Event()

    def _transform(self, df):
        self.started.set()
        time.sleep(self._delay_s)
        return df.with_column("doubled", np.asarray(df.col("x")) * 2.0)


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def _status(url, payload, headers=None, timeout=10):
    """(status, body, headers) of one POST, HTTP errors included."""
    try:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            body = json.loads(body)
        except ValueError:
            pass
        return e.code, body, dict(e.headers)


def _concurrent(fn, n):
    out, lock = [], threading.Lock()

    def run(i):
        r = fn(i)
        with lock:
            out.append(r)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def test_healthz_baseline_ok():
    with ServingServer(_SlowDouble(0.0), max_latency_ms=2) as server:
        assert _post(server.url, {"x": 1.0})["doubled"] == 2.0
        health = _get(f"{_base(server)}/healthz")
    assert health["status"] == "ok"
    assert health["served"] >= 1
    assert health["queueDepth"] == 0
    assert health["maxQueue"] == 256


def test_slow_model_sheds_load_with_retry_after_and_degraded_health():
    with ServingServer(_SlowDouble(0.25), max_queue=4, max_batch_size=1,
                       max_latency_ms=1, request_timeout_s=10,
                       retry_after_s=2) as server:
        health = {}

        def probe():
            # mid-overload: the queue filled and shed at least once
            _wait_for(lambda: server._stats["rejected"] >= 1)
            health.update(_get(f"{_base(server)}/healthz"))

        prober = threading.Thread(target=probe)
        prober.start()
        results = _concurrent(
            lambda i: _status(server.url, {"x": float(i)}), 16)
        prober.join(timeout=10)
    codes = [c for c, _, _ in results]
    assert 503 in codes, codes
    assert 200 in codes, codes
    assert all(h.get("Retry-After") == "2"
               for c, _, h in results if c == 503)
    assert health["status"] == "degraded"
    assert health["rejected"] >= 1


def test_request_timeout_and_deadline_504():
    with ServingServer(_SlowDouble(0.5), max_batch_size=1,
                       max_latency_ms=1,
                       request_timeout_s=0.1) as server:
        code, _, _ = _status(server.url, {"x": 1.0})
        assert code == 504
    # an X-Deadline-Ms budget that expires while queued behind a slow
    # batch is shed at dequeue with an attributed 504
    with ServingServer(_SlowDouble(0.5), max_batch_size=1,
                       max_latency_ms=1) as server:
        first = threading.Thread(
            target=_status, args=(server.url, {"x": 1.0}))
        first.start()
        assert server.model.started.wait(10)
        code, body, _ = _status(server.url, {"x": 2.0,
                                             "__tenant__": "t1"},
                                headers={"X-Deadline-Ms": "50"})
        first.join(timeout=10)
        health = _get(f"{_base(server)}/healthz")
    assert code == 504
    assert body["shed"] == "deadline" and body["tenant"] == "t1"
    assert body["model"] == "default"
    assert health["shed_deadline"] == 1


def test_tenant_buckets_and_priority_shedding(monkeypatch):
    monkeypatch.setenv(env.SERVE_TENANT_RATE, "0.001")
    monkeypatch.setenv(env.SERVE_TENANT_BURST, "2")
    with ServingServer(_SlowDouble(0.0), max_latency_ms=1) as server:
        codes = [_status(server.url, {"x": 1.0, "__tenant__": "hot"})[0]
                 for _ in range(3)]
        other = _status(server.url, {"x": 1.0}, {"X-Tenant": "calm"})[0]
        mh = _get(f"{_base(server)}/models/default/healthz")
    assert codes == [200, 200, 503] and other == 200
    assert mh["tenants"]["hot"]["shed_tenant"] == 1
    assert mh["shed_tenant"] == 1
    # past the high-water mark, low-priority requests shed
    monkeypatch.delenv(env.SERVE_TENANT_RATE)
    with ServingServer(_SlowDouble(0.5), max_batch_size=1,
                       max_latency_ms=1, queue_high_water=1) as server:
        blockers = [threading.Thread(target=_status,
                                     args=(server.url, {"x": 1.0}))
                    for _ in range(3)]
        for t in blockers:
            t.start()
        # one batch scoring, two requests queued past the mark of 1
        _wait_for(lambda: len(server._models["default"].queue) >= 2)
        low = _status(server.url, {"x": 1.0, "__priority__": "low"})
        for t in blockers:
            t.join(timeout=10)
    assert low[0] == 503 and "low-priority" in low[1]["error"]


def test_error_replies_and_id_echo():
    class _Failing(Transformer):
        def _transform(self, df):
            raise RuntimeError("model exploded")

    with ServingServer(models={"ok": _SlowDouble(0.0),
                               "bad": _Failing()},
                       max_latency_ms=1) as server:
        base = _base(server)
        assert _post(server.url, {"x": 2.0, "id": "r1"}) == \
            {"doubled": 4.0, "id": "r1"}
        assert _post(server.url, {"x": 2.0, "__id__": 7}) == \
            {"doubled": 4.0, "id": 7}
        assert _status(f"{base}/models/bad/score", {"x": 1.0})[0] == 500
        assert _status(f"{base}/nowhere", {"x": 1.0})[0] == 404
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=5)
        try:
            conn.request("POST", "/score", body=b"{not json",
                         headers={"Content-Length": "9"})
            r = conn.getresponse()
            r.read()
            assert r.status == 400
            conn.putrequest("POST", "/score")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"0\r\n\r\n")
            r = conn.getresponse()
            r.read()
            assert r.status == 411
        finally:
            conn.close()
        assert _get(f"{base}/models/bad/healthz")["errors"] == 1


def test_connection_cap_rejects_with_503():
    with ServingServer(_SlowDouble(0.0), max_connections=2,
                       max_latency_ms=2) as server:
        held = []
        try:
            for _ in range(2):  # two keep-alive connections, each a thread
                c = http.client.HTTPConnection(server.host, server.port,
                                               timeout=5)
                c.request("GET", "/healthz")
                r = c.getresponse()
                assert r.status == 200
                r.read()
                held.append(c)
            c3 = http.client.HTTPConnection(server.host, server.port,
                                            timeout=5)
            c3.request("GET", "/healthz")
            r3 = c3.getresponse()
            assert r3.status == 503
            assert r3.headers.get("Retry-After") is not None
            c3.close()
        finally:
            for c in held:
                c.close()


def test_idle_keepalive_timeout_closes_connection():
    with ServingServer(_SlowDouble(0.0), idle_timeout_s=0.3,
                       max_latency_ms=2) as server:
        s = socket.create_connection((server.host, server.port),
                                     timeout=5)
        try:
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            buf = b""
            while b"}" not in buf:
                chunk = s.recv(4096)
                assert chunk, "connection died before the response"
                buf += chunk
            assert b"200" in buf.split(b"\r\n", 1)[0]
            time.sleep(0.8)  # idle past the cap
            s.settimeout(2)
            assert s.recv(4096) == b"", "idle connection was not closed"
        finally:
            s.close()


def test_continuous_server_bounds_inflight():
    server = ContinuousServingServer(_SlowDouble(0.5), max_queue=1).start()
    try:
        first = []
        t = threading.Thread(target=lambda: first.append(
            _status(server.url, {"x": 0.0})[0]))
        t.start()
        # one request holds the only in-flight slot while it scores
        assert server.model.started.wait(10)
        codes = [c for c, _, _ in _concurrent(
            lambda i: _status(server.url, {"x": float(i)}), 3)]
        t.join(timeout=10)
        assert 503 in codes and first == [200], (codes, first)
    finally:
        server.stop()


def test_stop_releases_waiting_requests():
    server = ServingServer(_SlowDouble(0.4), max_batch_size=1,
                           max_latency_ms=1).start()
    results = []
    threads = [threading.Thread(
        target=lambda i=i: results.append(
            _status(server.url, {"x": float(i)})[0]))
        for i in range(4)]
    for t in threads:
        t.start()
    assert server.model.started.wait(10)
    _wait_for(lambda: len(server._models["default"].queue) == 3)
    server.stop()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(results) == 4 and set(results) <= {200, 503}
    assert 503 in results
    assert not server._batch_thread.is_alive()


# --- example 01 on the port ----------------------------------------------------

@pytest.mark.parametrize("fit_in", ["jax", "port"])
def test_example_01_flow_on_the_port(higgs, tmp_path, fit_in):
    """fit -> save -> ``PipelineStage.load`` -> ``serve_continuous`` ->
    one POST equal to ``transform`` (the JAX-fitted model: equal to the
    JAX model's ``transform`` too)."""
    ref, port, x = higgs
    if fit_in == "port":
        xs, ys = _make_data(np.random.default_rng(0), n=1500)
        port = estimators.LightGBMClassifier(
            numIterations=10, numLeaves=15, maxBin=63).set_device(
            "cpu").fit(DataFrame({"features": xs, "label": ys}))
        x = xs
    port.save(str(tmp_path / "gbdt-model"))
    loaded = PipelineStage.load(str(tmp_path / "gbdt-model"))
    assert loaded._device is None          # a loaded model: the card
    server = serve_continuous(loaded.set_device("cpu"), warmup_payload={
        "features": x[0].tolist()})
    try:
        assert _get(f"{_base(server)}/healthz")["binned"]["active"]
        reply = _post(server.url, {"features": x[1].tolist()})
    finally:
        server.stop()
    want = loaded.transform(DataFrame({"features": x[:2]}))
    assert reply["prediction"] == float(want["prediction"][1])
    assert reply["probability"] == [float(v)
                                    for v in want["probability"][1]]
    if fit_in == "jax":
        jwant = ref.transform(JaxFrame({"features": x[:2]}))
        assert reply["rawPrediction"] == [
            float(v) for v in jwant["rawPrediction"][1]]
        assert reply["probability"] == [float(v)
                                        for v in jwant["probability"][1]]


# --- out of the slice, and the card -------------------------------------------

def test_fleet_and_lifecycle_raise_naming_a6d():
    """ROADMAP A6d is in the port: none of the lifecycle and fleet calls
    that raised ``NotImplementedError`` naming it does so now (their
    contracts are held against the JAX package in
    ``test_torch_lifecycle``, ``test_torch_fleet`` and
    ``test_torch_refresh``)."""
    server = ServingServer(_DoubleModel(), max_latency_ms=1.0).start()
    fleet = None
    try:
        probe = {"value": 1.0}
        assert server.swap_model("default", _DoubleModel(),
                                 probe_payload=probe)["model"] == "default"
        server.abort_swap(server.prepare_swap("default", _DoubleModel(),
                                              probe_payload=probe))
        server.commit_swap(server.prepare_swap("default", _DoubleModel(),
                                               probe_payload=probe))
        server.observe_log(lambda *a: None)
        assert _post(server.url, {"value": 3.0})["out"] == 6.0
        assert server.drain(timeout_s=5.0)
        server.kill()
        fleet = serve_distributed(_DoubleModel(), num_servers=1,
                                  max_latency_ms=1.0)
        assert isinstance(fleet, ServingFleet)
        client = FleetClient(fleet.registry_url, timeout=5.0)
        assert client.score({"value": 2.0})["out"] == 4.0
        for name in ("FleetSupervisor", "RefreshController",
                     "RefreshResult", "StreamBuffer", "SwapFailed"):
            assert name in port_io.__all__
            getattr(port_io, name)
    finally:
        server.stop()
        if fleet is not None:
            fleet.stop()


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("cls", [ServingServer, ContinuousServingServer])
def test_start_raises_without_a_card(higgs, monkeypatch, cls, mode):
    """A model that runs on the card (no ``set_device("cpu")``) cannot be
    served without one: ``start()`` raises, the binned plane does not
    downgrade, and the listener is closed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    _, port, _ = higgs
    monkeypatch.setenv(env.SERVE_BINNED, mode)
    server = cls(port.copy().set_device(None))
    with pytest.raises(DeviceUnavailable, match="no CUDA device"):
        server.start()
    assert server._models["default"].binned_reason in (
        None, f"disabled ({env.SERVE_BINNED}=off)")
    assert server._httpd.socket.fileno() == -1
    server.stop()

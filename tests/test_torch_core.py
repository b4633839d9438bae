"""The port's host-side core (``core/param.py``, ``dataframe.py``,
``pipeline.py``, ``serialize.py``, ``timer.py``, ``logging_utils.py``)
against the JAX package's copies on the same inputs: the same values,
the same validation errors, the same param surface, the same
DataFrame results, and save / load round trips (a stage saved by the
JAX package loads into the port's class of the same name)."""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import dataframe as jax_df
from mmlspark_tpu.core import param as jax_param
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu_torch.core import dataframe, param, pipeline
from mmlspark_tpu_torch.core.logging_utils import SINK, scrub
from mmlspark_tpu_torch.core.timer import InstrumentationMeasures
from mmlspark_tpu_torch.models.gbdt import estimators

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)


def _outcome(fn, *args, **kw):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:     # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("conv,value", [
    ("to_int", 3), ("to_int", 3.0), ("to_int", 3.5), ("to_int", True),
    ("to_int", "3"), ("to_float", 2), ("to_float", False),
    ("to_float", "x"), ("to_bool", True), ("to_bool", 1),
    ("to_str", "a"), ("to_str", 1), ("to_list", [1, 2.0]),
    ("to_list", (3,)), ("to_list", 5), ("to_list", [1.5]),
])
def test_converters_match_jax(conv, value):
    def get(mod):
        fn = getattr(mod, conv)
        return fn(mod.to_int) if conv == "to_list" else fn

    assert _outcome(get(param), value) == _outcome(get(jax_param), value)


@pytest.mark.parametrize("kw", [
    {"numIterations": 0}, {"learningRate": -1.0}, {"numLeaves": 1.5},
    {"boostingType": "forest"}, {"isUnbalance": "yes"}, {"maxDepth": True},
    {"featureFraction": 0.0}, {"baggingFraction": 1.5},
    {"parallelism": "mpi"}, {"maxBin": 3}, {"noSuchParam": 1},
    {"categoricalSlotIndexes": [1, "a"]}, {"scalePosWeight": 0.0},
    {"numIterations": 7, "learningRate": 0.25},
])
def test_estimator_params_validate_as_jax(kw):
    want = _outcome(lambda: jax_est.LightGBMClassifier(**kw)._paramMap)
    got = _outcome(lambda: estimators.LightGBMClassifier(**kw)._paramMap)
    assert got == want


@pytest.mark.parametrize("name", ["LightGBMClassifier", "LightGBMRegressor",
                                  "LightGBMClassificationModel",
                                  "LightGBMRegressionModel"])
def test_param_surface_matches_jax(name):
    """The same param names, defaults and complex flags (docs may say
    where the port differs)."""
    def surface(cls):
        return {p.name: (p.default, p.is_complex) for p in cls.params()}

    assert surface(getattr(estimators, name)) == \
        surface(getattr(jax_est, name))


def test_copy_overrides_and_keeps_the_device():
    est = estimators.LightGBMRegressor(numIterations=5).set_device("cpu")
    dup = est.copy(numLeaves=7)
    assert dup.get("numLeaves") == 7 and est.get("numLeaves") == 31
    assert dup.get("numIterations") == 5 and dup._device == "cpu"
    dup.set("numIterations", 9)
    assert est.get("numIterations") == 5
    assert "device" not in est.simple_param_values()
    with pytest.raises(param.ParamValidationError):
        est.copy(numLeaves=1)
    # None clears an explicit value
    assert not est.copy(numIterations=None).is_set("numIterations")


def _frames(mod):
    rng = np.random.default_rng(0)
    return mod.DataFrame({"a": rng.integers(0, 4, size=50),
                          "v": rng.normal(size=(50, 3)),
                          "s": [f"r{i}" for i in range(50)]},
                         metadata={"v": {"slots": ["x", "y", "z"]}})


@pytest.mark.parametrize("op", [
    lambda d: d.with_column("b", d["a"] * 2),
    lambda d: d.with_columns({"a": d["a"] + 1, "c": d["a"]}),
    lambda d: d.select("v", "a"), lambda d: d.drop("s"),
    lambda d: d.rename({"a": "k"}), lambda d: d.take_rows([3, 1, 4]),
    lambda d: d.filter(d["a"] > 1), lambda d: d.head(7),
    lambda d: d.sort("a", ascending=False), lambda d: d.sample(0.3, seed=2),
    lambda d: d.random_split([0.7, 0.3], seed=1)[1],
    lambda d: type(d).concat([d.head(3), d.take_rows([9])]),
    lambda d: d.with_metadata("a", {"categorical": True}),
])
def test_dataframe_ops_match_jax(op):
    got, want = op(_frames(dataframe)), op(_frames(jax_df))
    assert got.columns == want.columns and got.num_rows == want.num_rows
    assert got.schema() == want.schema()
    for name in got.columns:
        np.testing.assert_array_equal(got[name], want[name])
        assert got.metadata(name) == want.metadata(name)


def test_dataframe_group_indices_and_errors_match_jax():
    got, want = _frames(dataframe), _frames(jax_df)
    g, w = got.group_indices("a"), want.group_indices("a")
    assert sorted(g) == sorted(w)
    for k in g:
        np.testing.assert_array_equal(g[k], w[k])
    for mod in (dataframe, jax_df):
        with pytest.raises(KeyError, match="no column 'zz'"):
            _frames(mod).col("zz")
    assert _outcome(dataframe.DataFrame, {"a": [1, 2], "b": [1]}) == \
        _outcome(jax_df.DataFrame, {"a": [1, 2], "b": [1]})
    assert not hasattr(dataframe.DataFrame, "to_device")


def _reg_frame(n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = np.round(2 * x[:, 0] - x[:, 1] + 3)
    return x, y


def test_pipeline_fit_save_load_round_trip(tmp_path):
    x, y = _reg_frame()
    df = dataframe.DataFrame({"features": x, "label": y})
    pipe = pipeline.Pipeline([estimators.LightGBMRegressor(
        numIterations=4, numLeaves=7, maxBin=31).set_device("cpu")])
    fitted = pipe.fit(df)
    assert isinstance(fitted, pipeline.PipelineModel)
    out = fitted.transform(df)
    fitted.save(str(tmp_path / "pm"))
    loaded = pipeline.PipelineStage.load(str(tmp_path / "pm"))
    stage = loaded.get("stages")[0]
    assert stage.uid == fitted.get("stages")[0].uid
    assert stage._device is None                 # a loaded model: the card
    stage.set_device("cpu")
    np.testing.assert_array_equal(loaded.transform(df)["prediction"],
                                  out["prediction"])
    assert stage.simple_param_values() == \
        fitted.get("stages")[0].simple_param_values()


def test_a_stage_saved_by_the_jax_package_loads_into_the_port(tmp_path):
    x, y = _reg_frame(seed=1)
    model = jax_est.LightGBMRegressor(numIterations=3, numLeaves=7,
                                      maxBin=31).fit(
        jax_df.DataFrame({"features": x, "label": y}))
    model.save(str(tmp_path / "m"))
    port = pipeline.PipelineStage.load(str(tmp_path / "m"))
    assert type(port) is estimators.LightGBMRegressionModel
    port.set_device("cpu")
    got = port.transform(dataframe.DataFrame({"features": x}))["prediction"]
    want = model.transform(jax_df.DataFrame({"features": x}))["prediction"]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        pipeline.PipelineStage.load(str(tmp_path / "absent"))


def test_fit_and_transform_are_logged():
    x, y = _reg_frame(n=100)
    SINK.drain()
    est = estimators.LightGBMRegressor(numIterations=1).set_device("cpu")
    est.fit(dataframe.DataFrame({"features": x, "label": y}))
    events = SINK.drain()
    assert [(e["className"], e["method"], e["numRows"]) for e in events] \
        == [("LightGBMRegressor", "fit", 100)]
    assert events[0]["uid"] == est.uid and events[0]["seconds"] > 0
    assert scrub("url?sig=abc&x=1") == "url?sig=[REDACTED]&x=1"


def test_instrumentation_measures():
    m = InstrumentationMeasures()
    for name in ("binning", "training", "binning"):
        with m.phase(name):
            pass
    assert list(m.as_dict()) == ["binning", "training"]
    assert m.count("binning") == 2 and m.count("absent") == 0
    both = m.merged(m)
    assert both.count("training") == 2
    assert both.total_seconds() == pytest.approx(2 * m.total_seconds())

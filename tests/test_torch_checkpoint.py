"""Checkpointed fits in the port (``LightGBMRegressor`` with
``checkpointDir`` / ``checkpointInterval``, ``fit_incremental``'s
checkpoint arguments) and the checkpoint store of ``core/serialize.py``,
against the JAX package's.

Tolerances, by case:

  - a fit killed (an armed ``gbdt.train_step`` raise, or SIGKILL of a
    child interpreter) and resumed equals the uninterrupted fit with the
    same interval bit for bit (model strings equal);
  - a checkpointed fit against a monolithic one: bit for bit where no
    row holds a value that raw-threshold and binned routing send apart
    (ROADMAP C3: a resumed segment's warm start scores the raw rows);
    the test counts those rows and asserts that case;
  - across the packages (a directory written by one resumes in the
    other), on the q8 plane on both sides (every quantization exponent
    of these data lies where XLA's ``exp2`` is a power of two, which the
    port's ``_pow2_scale`` always is: ROADMAP C, closed list; and q8 bin
    sums are exact in float32): model strings equal;
  - the fingerprint of ``checkpoint_meta.json``: the same string in both
    packages for the same data and params.

The JAX side pins ``MMLSPARK_TPU_HIST_FORMULATION=per_feature`` (ROADMAP
C1), EFB and out-of-core training off.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.core import serialize as jax_serialize
from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import faults, serialize
from mmlspark_tpu_torch.core.faults import FaultInjected
from mmlspark_tpu_torch.core.logging_utils import SINK, reset_warn_once
from mmlspark_tpu_torch.models.gbdt import estimators, trainer
from mmlspark_tpu_torch.ops.ingest import resolve_spill_verify

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(numIterations=12, numLeaves=8, maxBin=32)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 "MMLSPARK_TPU_SPILL_VERIFY", "MMLSPARK_TORCH_SPILL_VERIFY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    jax_faults.reset()
    reset_warn_once()
    SINK.drain()
    yield
    faults.reset()
    jax_faults.reset()


def _q8(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _data(n=600, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = 2.0 * x[:, 0] - x[:, 1] + rng.normal(size=n) * 0.1
    return x, y


def _reg(**params):
    return estimators.LightGBMRegressor(**params).set_device("cpu")


def _fit(x, y, **params):
    return _reg(**params).fit(DataFrame({"features": x, "label": y}))


def _jax_fit(x, y, **params):
    return jax_est.LightGBMRegressor(**params).fit(
        JaxFrame({"features": x, "label": y}))


def _txt(ckdir):
    return sorted(n for n in os.listdir(ckdir) if n.endswith(".txt"))


def _rows_routed_apart(model, x):
    """Rows holding a value whose float32 bin (raw-threshold scoring) is
    not its bin (training), ROADMAP C3."""
    m = model.bin_mapper
    bins = m.transform(x)
    bins32 = np.stack([np.searchsorted(e.astype(np.float32),
                                       x[:, f].astype(np.float32),
                                       side="left") + 1
                       for f, e in enumerate(m.upper_edges)], axis=1)
    return int((bins32 != bins).any(axis=1).sum())


# --- the ports of tests/gbdt/test_checkpoint.py ---------------------------------

def test_checkpointed_fit_matches_monolithic(tmp_path):
    x, y = _data(n=800)
    mono = _fit(x, y, **KW)
    ck = _fit(x, y, checkpointDir=str(tmp_path / "ck"),
              checkpointInterval=5, **KW)
    assert _txt(tmp_path / "ck") == ["checkpoint_10.txt", "checkpoint_12.txt",
                                     "checkpoint_5.txt"]
    assert (tmp_path / "ck" / "checkpoint_meta.json").exists()
    assert sorted(n for n in os.listdir(tmp_path / "ck")
                  if n.endswith(".crc32")) == [
        "checkpoint_10.txt.crc32", "checkpoint_12.txt.crc32",
        "checkpoint_5.txt.crc32"]
    assert _rows_routed_apart(mono, x) == 0
    assert ck.get_model_string() == mono.get_model_string()


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    x, y = _data(n=800)
    ckdir = str(tmp_path / "ck")
    kw = dict(KW, checkpointDir=ckdir, checkpointInterval=4)
    full = _fit(x, y, **kw)
    for name in ("checkpoint_8.txt", "checkpoint_12.txt"):
        os.remove(os.path.join(ckdir, name))
    resumed = _fit(x, y, **kw)
    assert resumed.booster.num_trees == 12
    assert resumed.get_model_string() == full.get_model_string()


def test_resume_refuses_mismatched_config(tmp_path):
    x, y = _data(n=800)
    kw = dict(KW, numIterations=8, checkpointDir=str(tmp_path / "ck"),
              checkpointInterval=4)
    _fit(x, y, **kw)
    with pytest.raises(ValueError, match="different config or dataset"):
        _fit(x, y, **{**kw, "numLeaves": 16})
    with pytest.raises(ValueError, match="different config or dataset"):
        _fit(x + 1.0, y, **kw)
    more = _fit(x, y, **{**kw, "numIterations": 12})
    assert more.booster.num_trees == 12


def test_checkpoint_beyond_num_iterations_raises(tmp_path):
    x, y = _data()
    kw = dict(KW, checkpointDir=str(tmp_path / "ck"), checkpointInterval=4)
    _fit(x, y, **kw)
    with pytest.raises(ValueError, match="exceeds numIterations=8"):
        _fit(x, y, **{**kw, "numIterations": 8})


@pytest.mark.parametrize("params,error,match", [
    ({"checkpointInterval": 2}, ValueError, "requires checkpointDir"),
    ({"checkpointInterval": 2, "checkpointDir": "ck",
      "earlyStoppingRound": 2, "validationIndicatorCol": "v"}, ValueError,
     "early stopping"),
    ({"checkpointInterval": 2, "checkpointDir": "ck", "numBatches": 2},
     ValueError, "numBatches"),
    # dart + checkpoints: the reference's ValueError
    ({"checkpointInterval": 2, "checkpointDir": "ck",
      "boostingType": "dart"}, ValueError, "does not compose with DART"),
])
def test_settings_that_do_not_compose_with_checkpoints(tmp_path, monkeypatch,
                                                       params, error, match):
    monkeypatch.chdir(tmp_path)
    x, y = _data(n=200)
    df = DataFrame({"features": x, "label": y,
                    "v": np.arange(200) % 5 == 0})
    with pytest.raises(error, match=match):
        _reg(numIterations=4, **params).fit(df)


# --- the ports of tests/gbdt/test_fault_injection.py ----------------------------

def test_armed_fault_kill_and_resume_bitwise(tmp_path):
    """Hit 9 of ``gbdt.train_step`` is the first iteration of the third
    segment at interval 4: checkpoints 4 and 8 are committed, and the
    resumed fit is the uninterrupted one bit for bit."""
    x, y = _data()
    kw = dict(KW, checkpointInterval=4)
    ref = _fit(x, y, checkpointDir=str(tmp_path / "a"), **kw)
    ckb = str(tmp_path / "b")
    with faults.injected("gbdt.train_step", "raise", nth=9):
        with pytest.raises(FaultInjected):
            _fit(x, y, checkpointDir=ckb, **kw)
    assert _txt(ckb) == ["checkpoint_4.txt", "checkpoint_8.txt"]
    resumed = _fit(x, y, checkpointDir=ckb, **kw)
    assert resumed.booster.num_trees == 12
    assert resumed.get_model_string() == ref.get_model_string()
    df = DataFrame({"features": x})
    np.testing.assert_array_equal(resumed.transform(df)["prediction"],
                                  ref.transform(df)["prediction"])


def test_checkpoint_write_failure_degrades_not_dies(tmp_path):
    x, y = _data(n=300)
    ckdir = str(tmp_path / "ck")
    with faults.injected("checkpoint.write", "raise", count=None,
                         exc=OSError("disk full")):
        model = _fit(x, y, numIterations=6, numLeaves=4, maxBin=16,
                     checkpointDir=ckdir, checkpointInterval=3)
    assert model.booster.num_trees == 6
    assert not _txt(ckdir)
    keys = [e.get("key") for e in SINK.drain()
            if e.get("event") == "degradation"]
    assert "gbdt.checkpoint_skip" in keys


def test_disk_full_is_attributed_and_degrades(tmp_path):
    x, y = _data(n=300)
    ckdir = str(tmp_path / "ck")
    with faults.injected("io.disk_full", "raise", nth=2, count=1):
        model = _fit(x, y, numIterations=6, numLeaves=4, maxBin=16,
                     checkpointDir=ckdir, checkpointInterval=3)
    # hit 1 the fingerprint, hit 2 checkpoint_3.txt (skipped), then 6
    assert model.booster.num_trees == 6
    assert _txt(ckdir) == ["checkpoint_6.txt"]
    with faults.injected("io.disk_full", "raise"):
        with pytest.raises(serialize.DiskFull, match=r"\[io.disk_full\]"):
            serialize.atomic_write(str(tmp_path / "f.txt"), "x")
    assert not os.path.exists(tmp_path / "f.txt")


def test_corrupt_partial_checkpoint_is_invisible(tmp_path):
    x, y = _data(n=800)
    ckdir = str(tmp_path / "ck")
    kw = dict(KW, numIterations=8, checkpointDir=ckdir, checkpointInterval=4)
    _fit(x, y, **kw)
    os.remove(os.path.join(ckdir, "checkpoint_8.txt"))
    with open(os.path.join(ckdir, ".checkpoint_8.tmp"), "w") as fh:
        fh.write("tree\nversion=v4\ngarbage")
    with open(os.path.join(ckdir, "checkpoint_8.txt.tmp"), "w") as fh:
        fh.write("tree\nversion=v4\ngarbage")
    resumed = _fit(x, y, **{**kw, "numIterations": 12})
    assert resumed.booster.num_trees == 12
    assert resumed.get_model_string() == \
        _fit(x, y, **{**kw, "checkpointDir": str(tmp_path / "b"),
                      "numIterations": 12}).get_model_string()


def test_sigkill_mid_fit_resumes_bit_exact(tmp_path):
    """A child interpreter killed with SIGKILL right after its first
    checkpoint lands (an armed delay from hit 5 on keeps it mid-fit)
    resumes here to the uninterrupted fit bit for bit."""
    ckdir = str(tmp_path / "ck")
    script = (
        "import numpy as np\n"
        "from mmlspark_tpu_torch import DataFrame, LightGBMRegressor\n"
        "rng = np.random.default_rng(7)\n"
        "x = rng.normal(size=(600, 4))\n"
        "y = 2.0 * x[:, 0] - x[:, 1] + rng.normal(size=600) * 0.1\n"
        f"LightGBMRegressor(numIterations=12, numLeaves=8, maxBin=32, "
        f"checkpointDir={ckdir!r}, checkpointInterval=4).set_device('cpu')"
        ".fit(DataFrame({'features': x, 'label': y}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               MMLSPARK_TORCH_FAULTS="gbdt.train_step:delay:5:0.5")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if os.path.isdir(ckdir) and _txt(ckdir):
                break
            if proc.poll() is not None:
                pytest.fail("the fit ended before the kill: "
                            f"{proc.communicate()[1][-500:]!r}")
            time.sleep(0.02)
        else:
            pytest.fail("no checkpoint appeared within 20 s")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGKILL
    assert _txt(ckdir) == ["checkpoint_4.txt"]
    x, y = _data()
    kw = dict(KW, checkpointInterval=4)
    resumed = _fit(x, y, checkpointDir=ckdir, **kw)
    ref = _fit(x, y, checkpointDir=str(tmp_path / "ref"), **kw)
    assert resumed.get_model_string() == ref.get_model_string()


# --- digests: a bit-rotted checkpoint falls back a generation ------------------

def test_corrupt_crc32_falls_back_a_generation(tmp_path, monkeypatch):
    x, y = _data()
    ckdir = str(tmp_path / "ck")
    kw = dict(KW, checkpointDir=ckdir, checkpointInterval=4)
    clean = _fit(x, y, **kw)
    os.remove(os.path.join(ckdir, "checkpoint_12.txt"))
    path = os.path.join(ckdir, "checkpoint_8.txt")
    raw = bytearray(open(path, "rb").read())
    raw[-10] ^= 0x01                      # one flipped bit near the end
    open(path, "wb").write(bytes(raw))
    assert estimators.LightGBMRegressor._latest_checkpoint(ckdir) == \
        (4, os.path.join(ckdir, "checkpoint_4.txt"))
    resumed = _fit(x, y, **kw)
    assert resumed.get_model_string() == clean.get_model_string()
    assert any(e.get("key") == f"gbdt.checkpoint_bitrot.{path}"
               for e in SINK.drain())
    # off trusts the disk: the rotten checkpoint is taken as it is
    monkeypatch.setenv("MMLSPARK_TORCH_SPILL_VERIFY", "off")
    assert estimators.LightGBMRegressor._latest_checkpoint(ckdir)[0] == 12


@pytest.mark.parametrize("value,want", [
    (None, "auto"), ("on", "on"), ("OFF", "off"), (" auto ", "auto"),
    ("", "auto"), ("bogus", "auto")])
def test_resolve_spill_verify_reads_the_port_knob(monkeypatch, value, want):
    monkeypatch.setenv("MMLSPARK_TPU_SPILL_VERIFY", "off")   # never read
    if value is not None:
        monkeypatch.setenv("MMLSPARK_TORCH_SPILL_VERIFY", value)
    assert resolve_spill_verify() == want


# --- across the packages ----------------------------------------------------

def test_fingerprint_is_the_jax_fingerprint(tmp_path):
    x, y = _data()
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=len(y))
    cols = {"features": x, "label": y, "w": w}
    params = dict(KW, checkpointInterval=6, weightCol="w", lambdaL2=0.5)
    _reg(checkpointDir=str(tmp_path / "p"), **params).fit(DataFrame(cols))
    jax_est.LightGBMRegressor(checkpointDir=str(tmp_path / "j"),
                              **params).fit(JaxFrame(cols))
    meta = [json.load(open(tmp_path / d / "checkpoint_meta.json"))
            for d in ("p", "j")]
    assert meta[0] == meta[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directory_crosses_packages(tmp_path, monkeypatch, writer):
    """A fit killed at hit 9 in one package resumes in the other to the
    writer's uninterrupted fit, model strings equal."""
    _q8(monkeypatch)
    x, y = _data()
    kw = dict(KW, checkpointInterval=4)
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        ref = _jax_fit(x, y, checkpointDir=str(tmp_path / "ref"), **kw)
        with jax_faults.injected("gbdt.train_step", "raise", nth=9):
            with pytest.raises(jax_faults.FaultInjected):
                _jax_fit(x, y, checkpointDir=ckdir, **kw)
        assert _txt(ckdir) == ["checkpoint_4.txt", "checkpoint_8.txt"]
        resumed = _fit(x, y, checkpointDir=ckdir, **kw)
    else:
        ref = _fit(x, y, checkpointDir=str(tmp_path / "ref"), **kw)
        with faults.injected("gbdt.train_step", "raise", nth=9):
            with pytest.raises(FaultInjected):
                _fit(x, y, checkpointDir=ckdir, **kw)
        assert _txt(ckdir) == ["checkpoint_4.txt", "checkpoint_8.txt"]
        resumed = _jax_fit(x, y, checkpointDir=ckdir, **kw)
    assert resumed.get_model_string() == ref.get_model_string()


def test_fit_incremental_with_checkpoints_matches_jax(tmp_path, monkeypatch):
    _q8(monkeypatch)
    x, y = _data(n=800)
    x1, y1, x2, y2 = x[:400], y[:400], x[400:], y[400:] + 0.5
    base = _fit(x1, y1, numIterations=4, numLeaves=8, maxBin=32)
    jbase = _jax_fit(x1, y1, numIterations=4, numLeaves=8, maxBin=32)
    assert base.get_model_string() == jbase.get_model_string()
    est = _reg(numLeaves=8, maxBin=32)
    ckp = str(tmp_path / "p")
    with faults.injected("gbdt.train_step", "raise", nth=5):
        with pytest.raises(FaultInjected):
            est.fit_incremental(DataFrame({"features": x2, "label": y2}),
                                base, num_new_trees=6, checkpoint_dir=ckp,
                                checkpoint_interval=2)
    assert _txt(ckp) == ["checkpoint_2.txt", "checkpoint_4.txt"]
    got = est.fit_incremental(DataFrame({"features": x2, "label": y2}), base,
                              num_new_trees=6, checkpoint_dir=ckp,
                              checkpoint_interval=2)
    want = jax_est.LightGBMRegressor(numLeaves=8, maxBin=32).fit_incremental(
        JaxFrame({"features": x2, "label": y2}), jbase, num_new_trees=6,
        checkpoint_dir=str(tmp_path / "j"), checkpoint_interval=2)
    assert got.booster.num_trees == 10
    assert got.get_model_string() == want.get_model_string()
    assert not est.is_set("checkpointDir")       # overrides ride a copy


# --- the store: save_checkpoint / load_latest_checkpoint / dir_digest ---------

def test_checkpoint_store_round_trips_and_falls_back(tmp_path):
    import torch
    ckdir = str(tmp_path / "store")
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "t": torch.arange(4), "step": 3, "name": "a"}
    serialize.save_checkpoint(ckdir, 3, state, "h1")
    serialize.save_checkpoint(ckdir, 7, {**state, "step": 7}, "h1")
    tag, got = serialize.load_latest_checkpoint(ckdir, "h1")
    assert tag == 7 and got["step"] == 7 and got["name"] == "a"
    np.testing.assert_array_equal(got["w"], state["w"])
    np.testing.assert_array_equal(got["t"], np.arange(4))
    with pytest.raises(ValueError, match="different config or dataset"):
        serialize.load_latest_checkpoint(ckdir, "h2")
    # bit-rot in the newest payload: skipped, the previous tag resumes
    payload = os.path.join(ckdir, "ckpt_00000007.npz")
    raw = bytearray(open(payload, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(raw))
    assert serialize.load_latest_checkpoint(ckdir, "h1")[0] == 3
    # a torn manifest is skipped too; validate() can refuse a tag
    with open(os.path.join(ckdir, "ckpt_00000009.json"), "w") as fh:
        fh.write('{"tag": 9, "configH')
    assert serialize.load_latest_checkpoint(ckdir, "h1")[0] == 3
    assert serialize.load_latest_checkpoint(
        ckdir, "h1", validate=lambda t, s: "no" if t == 3 else None) is None
    assert serialize.load_latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_store_reads_the_jax_store_and_digests_alike(tmp_path):
    ckdir = str(tmp_path / "store")
    state = {"w": np.linspace(0, 1, 5), "step": 5}
    jax_serialize.save_checkpoint(ckdir, 5, state, "h")
    tag, got = serialize.load_latest_checkpoint(ckdir, "h")
    assert tag == 5 and got["step"] == 5
    np.testing.assert_array_equal(got["w"], state["w"])
    serialize.save_checkpoint(ckdir, 6, state, "h")
    assert jax_serialize.load_latest_checkpoint(ckdir, "h")[0] == 6
    os.remove(os.path.join(ckdir, "ckpt_00000006.json"))
    os.remove(os.path.join(ckdir, "ckpt_00000006.npz"))
    assert serialize.dir_digest(ckdir) == jax_serialize.dir_digest(ckdir)

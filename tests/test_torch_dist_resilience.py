"""Resumable and elastic multi-device GBDT on ``torch.distributed``
(gloo, on the CPU): checkpointed fits under a mesh, ``fit_resilient``,
``shrink_mesh``, a real participant loss and a real hang.

Worlds of 2 and 4 ranks run once each, in processes started from this
file (``python test_torch_dist_resilience.py RANK WORLD STORE OUT_DIR``;
the ranks join through a ``file://`` store, which outlives a dead rank)
and each rank runs the scenarios of :func:`_scenarios` in order on a
``dp`` = world mesh (``fp == 1``), writing its records after each. The
last scenario of the 4-rank world loses rank 3 for real
(``os._exit(1)`` at a fault point mid-fit); the last of the 2-rank world
stalls rank 1 for real before a collective under an armed watchdog. A
second world of 4 (``... OUT_DIR kept``) loses rank 1, inside the kept
dp slice: the survivors agree on who survived through the store
(``resilience.agree_survivors``) and keep ranks 0 and 2.

The contract held here is stronger than the reference's: the port's
learners are the serial fit at every ``dp``, so a checkpointed fit under
a mesh — uninterrupted, killed and re-fit, resumed from a serial or a
JAX-package directory, or recovered by ``fit_resilient`` after a loss —
is bitwise the port's serial checkpointed fit (model strings equal).
Only the mesh's first rank touches the directory (``checkpoint.write``
hits counted per rank under a fault armed never to fire). The recovery
records are the JAX package's ``fit_resilient``'s under the same fault
schedule on its 8-device CPU mesh. The workers import torch and the port
only, and are killed past their timeout.
"""

import dataclasses
import os
import pathlib
import pickle
import shutil
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPAWNED = (2, 4)
SPAWN_TIMEOUT_S = 240
# the survivors' wait for each other in the store (the spawned ranks'
# resilience.RECOVERY_WAIT_S): a dead rank never posts
WAIT_S = 5.0
ITERS, INTERVAL = 6, 2
# the 2-rank world's real hang: rank 1 sleeps this long at its Nth
# ``allreduce`` hit while both ranks run the watchdog at this floor
HANG_S, HANG_NTH, HANG_MIN_S = 20.0, 10, 1.0


def _cols(n=256, f=6, seed=0):
    """The reference resilience tests' rows (``tests/parallel/
    test_resilience.py::_df``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = x @ rng.normal(size=f) + 0.1 * rng.normal(size=n)
    return {"features": x, "label": y}


def _clf_cols():
    cols = _cols(seed=1)
    return {"features": cols["features"],
            "label": (cols["label"] > 0).astype(np.float64)}


def _est(kind="reg", **kw):
    from mmlspark_tpu_torch.models.gbdt.estimators import (
        LightGBMClassifier, LightGBMRegressor)
    cls = LightGBMRegressor if kind == "reg" else LightGBMClassifier
    return cls(numIterations=ITERS, numLeaves=7, maxBin=32, seed=3,
               **kw).set_device("cpu")


def _frame(kind="reg"):
    from mmlspark_tpu_torch import DataFrame
    return DataFrame(_cols() if kind == "reg" else _clf_cols())


def _files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else None


def _counted(fn, *points):
    """(``fn()``, {point: hits}) with every fault reset, the hits counted
    under a fault armed on each point never to fire."""
    from mmlspark_tpu_torch.core import faults
    faults.reset()
    for p in points:
        faults.arm(p, "delay", nth=10 ** 9, count=None)
    try:
        out = fn()
        return out, {p: faults.hits(p) for p in points}
    finally:
        faults.reset()


# --- the ranks ----------------------------------------------------------------

def _scenarios(world, rank, out_dir, save):
    """Every scenario on this rank, in order; ``save(name, record)``
    after each."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.faults import FaultInjected
    from mmlspark_tpu_torch.parallel import mesh as M
    from mmlspark_tpu_torch.parallel import resilience as R

    mesh = M.create_mesh()
    mine = pathlib.Path(out_dir) / f"rank{rank}"
    mine.mkdir()

    # a checkpointed fit, uninterrupted, of each estimator
    for kind in ("reg", "clf"):
        ck = str(mine / f"uninterrupted_{kind}")
        model, hits = _counted(lambda: _est(
            kind, checkpointDir=ck, checkpointInterval=INTERVAL).set_mesh(
                mesh).fit(_frame(kind)), "checkpoint.write")
        save(f"uninterrupted_{kind}", {
            "model": model.get_model_string(), "hits": hits,
            "files": _files(ck)})

    # killed at the first iteration of segment 3 on every rank, then
    # re-fit: rank 0 from its directory, the others from an empty one
    for kind in ("reg", "clf"):
        ck = str(mine / f"killed_{kind}")
        est = _est(kind, checkpointDir=ck, checkpointInterval=INTERVAL)
        with faults.injected("gbdt.train_step", "raise", nth=5):
            try:
                est.set_mesh(mesh).fit(_frame(kind))
                killed = None
            except FaultInjected as e:
                killed = str(e)
        after_kill = _files(ck)
        if rank == 0 and kind == "reg":
            # kept for the serial resume in the test process
            shutil.copytree(ck, pathlib.Path(out_dir) / "mesh_killed")
        refit_dir = ck if rank == 0 else str(mine / f"empty_{kind}")
        os.makedirs(refit_dir, exist_ok=True)
        model, hits = _counted(lambda: est.copy(
            checkpointDir=refit_dir).set_mesh(mesh).fit(_frame(kind)),
            "gbdt.train_step", "checkpoint.write")
        save(f"killed_{kind}", {
            "killed": killed, "after_kill": after_kill,
            "model": model.get_model_string(), "hits": hits,
            "refit_files": _files(refit_dir)})

    # a directory a serial fit wrote (killed after checkpoint 4) resumes
    # under the mesh; only rank 0 is given it
    ck = (str(pathlib.Path(out_dir) / "serial_killed") if rank == 0
          else str(mine / "never_made"))
    model, hits = _counted(lambda: _est(
        checkpointDir=ck, checkpointInterval=INTERVAL).set_mesh(mesh).fit(
            _frame()), "gbdt.train_step")
    save("serial_dir", {"model": model.get_model_string(), "hits": hits,
                        "files": _files(ck)})

    if world == 2:
        # a directory the JAX package's LightGBMRegressor wrote (killed
        # after checkpoint 4), made by the test process meanwhile
        ready = pathlib.Path(out_dir) / "jax_ready"
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        while not ready.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        ck = (str(pathlib.Path(out_dir) / "jax_killed") if rank == 0
              else str(mine / "never_made_jax"))
        model, hits = _counted(lambda: _est(
            checkpointDir=ck, checkpointInterval=INTERVAL).set_mesh(
                mesh).fit(_frame()), "gbdt.train_step")
        save("jax_dir", {"model": model.get_model_string(), "hits": hits})

    # an armed watchdog that never fires keeps the bits: every
    # collective waited on by the mesh's waiter thread
    os.environ["MMLSPARK_TORCH_WATCHDOG_MULT"] = "4"
    try:
        model = _est().set_mesh(mesh).fit(_frame())
    finally:
        del os.environ["MMLSPARK_TORCH_WATCHDOG_MULT"]
    save("armed", {"model": model.get_model_string(),
                   "stalls": R.stall_count(),
                   "last_collective": M.last_collective()})

    # fit_resilient: a participant lost (injected on every rank) at the
    # first iteration of segment 3 shrinks dp to dp // 2
    loss = R.ParticipantLost(f"rank {world - 1} lost")
    with faults.injected("train.participant_loss", "raise", nth=5,
                         exc=loss):
        out = R.fit_resilient(_est(), _frame(), checkpoint_dir=str(
            mine / "resilient"), checkpoint_interval=INTERVAL, mesh=mesh)
    save("resilient", {
        "model": None if out.model is None
        else out.model.get_model_string(),
        "recoveries": [dataclasses.asdict(r) for r in out.recoveries],
        "mesh": None if out.mesh is None else (
            M.axis_size(out.mesh, M.DATA_AXIS), out.mesh.ranks,
            out.mesh.coords),
        "recovery_count": R.recovery_count(),
        "files": _files(str(mine / "resilient"))})

    if world == 2:
        # a loss that keeps firing, with nothing to shrink to (min_dp 2)
        with faults.injected("train.participant_loss", "raise", nth=1,
                             count=100, exc=R.ParticipantLost("flapping")):
            try:
                R.fit_resilient(_est(), _frame(), checkpoint_dir=str(
                    mine / "exhausted"), checkpoint_interval=INTERVAL,
                    mesh=mesh, min_dp=2)
                exhausted = None
            except R.ParticipantLost as e:
                exhausted = str(e)
        save("exhausted", exhausted)

        # a live shrink that drops dp coordinate 0: rank 1 alone re-forms
        # a mesh and reduces over it; rank 0 is not in the slice
        try:
            m1 = M.shrink_mesh(mesh, lost_ranks=[0])
            total = M.all_reduce(m1, torch.tensor([rank + 1.0]))
            live = (m1.ranks, m1.coords, M.axis_size(m1, M.DATA_AXIS),
                    float(total[0]))
        except ValueError as e:
            live = str(e)
        save("shrink_live", live)

    if world == 4:
        _real_loss(rank, mine, mesh, save)
    else:
        _real_hang(rank, mesh, save)


def _real_loss(rank, mine, mesh, save):
    """Rank 3 exits at its 5th ``train.participant_loss`` hit (the first
    iteration of segment 3) under ``fit_resilient``; the others recover
    through ``ParticipantLost``."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.parallel import resilience as R

    faults.reset()
    R.reset()
    if rank == 3:
        faults.arm("train.participant_loss", "corrupt", nth=5,
                   corrupt=lambda v: os._exit(1))
    t0 = time.monotonic()
    out = R.fit_resilient(_est(), _frame(), checkpoint_dir=str(
        mine / "real_loss"), checkpoint_interval=INTERVAL, mesh=mesh)
    save("real_loss", {
        "model": None if out.model is None
        else out.model.get_model_string(),
        "recoveries": [(r.cause, r.dp_before, r.dp_after, r.error)
                       for r in out.recoveries],
        "mesh_ranks": None if out.mesh is None else out.mesh.ranks,
        "wall_s": time.monotonic() - t0})


def _kept_slice_loss(rank, out_dir, save):
    """Rank 1 exits at its 5th ``train.participant_loss`` hit under
    ``fit_resilient``: it sits inside the kept slice (dp coordinates 0
    and 1), so the survivors 0, 2 and 3 agree that coordinate 1 is lost
    and keep the first two survivors, 0 and 2; rank 3 leaves."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.parallel import mesh as M
    from mmlspark_tpu_torch.parallel import resilience as R

    mesh = M.create_mesh()
    mine = pathlib.Path(out_dir) / f"rank{rank}"
    mine.mkdir()
    if rank == 1:
        faults.arm("train.participant_loss", "corrupt", nth=5,
                   corrupt=lambda v: os._exit(1))
    t0 = time.monotonic()
    try:
        out = R.fit_resilient(_est(), _frame(), checkpoint_dir=str(
            mine / "kept_loss"), checkpoint_interval=INTERVAL, mesh=mesh)
        rec = {"model": None if out.model is None
               else out.model.get_model_string(),
               "recoveries": [(r.cause, r.dp_before, r.dp_after, r.error)
                              for r in out.recoveries],
               "mesh": None if out.mesh is None else (
                   out.mesh.ranks, out.mesh.coords,
                   M.axis_size(out.mesh, M.DATA_AXIS)),
               "raised": None}
    except R.ParticipantLost as e:
        rec = {"raised": str(e)}
    rec["wall_s"] = time.monotonic() - t0
    rec["files"] = _files(str(mine / "kept_loss"))
    save("kept_loss", rec)


def _real_hang(rank, mesh, save):
    """Both ranks fit under an armed watchdog (MULT 4, MIN_S 1); rank 1
    sleeps ``HANG_S`` at its ``HANG_NTH``-th ``allreduce`` hit, before a
    collective, so rank 0 waits in that collective."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    from mmlspark_tpu_torch.parallel import resilience as R

    cols = _cols()
    binned = np.clip(cols["features"] * 4 + 16, 0, 31).astype(np.uint8)
    cfg = T.TrainConfig(objective="regression", num_iterations=ITERS,
                        num_leaves=7, max_bin=32)
    faults.reset()
    R.reset()
    os.environ["MMLSPARK_TORCH_WATCHDOG_MULT"] = "4"
    os.environ["MMLSPARK_TORCH_WATCHDOG_MIN_S"] = str(HANG_MIN_S)
    if rank == 1:
        faults.arm("allreduce", "delay", nth=HANG_NTH, delay_s=HANG_S)
    t0 = time.monotonic()
    try:
        T.train(binned, cols["label"], cfg, device="cpu", mesh=mesh)
        rec = {"stalled": None}
    except R.TrainStalled as e:
        rec = {"stalled": (e.classification, e.label, e.budget_s,
                           e.elapsed_s, e.report["boundary"],
                           e.report["last_collective"])}
    rec["wall_s"] = time.monotonic() - t0
    time.sleep(0.05)
    rec["watchdog_threads"] = [t.name for t in threading.enumerate()
                               if t.name.startswith("mmlspark-watchdog-")]
    save("real_hang", rec)


def _worker(rank, world, store, out_dir, what="scenarios"):
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from mmlspark_tpu_torch.parallel import resilience as R
    R.RECOVERY_WAIT_S = WAIT_S
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=90))
    res = {}
    path = pathlib.Path(out_dir) / f"rank{rank}.pkl"

    def save(name, record):
        res[name] = record
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(res))
        os.replace(tmp, path)

    if what == "kept":
        _kept_slice_loss(rank, out_dir, save)
    else:
        _scenarios(world, rank, out_dir, save)
    # peers may be dead or departed: leave without a collective teardown
    sys.stdout.flush()
    os._exit(0)


# --- the test process ------------------------------------------------------------

def _serial_fit(kind="reg", ckpt=None, **kw):
    return _est(kind, checkpointDir=ckpt, checkpointInterval=INTERVAL,
                **kw).fit(_frame(kind)).get_model_string()


def _killed_serial_dir(path):
    """A serial checkpointed fit killed at the first iteration of
    segment 3: checkpoints 2 and 4 in ``path``."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.faults import FaultInjected
    with faults.injected("gbdt.train_step", "raise", nth=5):
        with pytest.raises(FaultInjected):
            _serial_fit(ckpt=str(path))


def _jax_env(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")


def _jax_killed_dir(path):
    from mmlspark_tpu.core import faults as jax_faults
    from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
    from mmlspark_tpu.models.gbdt.estimators import LightGBMRegressor
    with jax_faults.injected("gbdt.train_step", "raise", nth=5):
        with pytest.raises(jax_faults.FaultInjected):
            LightGBMRegressor(numIterations=ITERS, numLeaves=7, maxBin=32,
                              seed=3, checkpointDir=str(path),
                              checkpointInterval=INTERVAL).fit(
                JaxFrame(_cols()))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{"serial": the port's serial references, world: [per-rank
    records], "out": {world: its directory}}: the worlds run while this
    process makes the serial references and the JAX package's
    directory."""
    from mmlspark_tpu_torch.core import faults

    faults.reset()
    serial_killed = tmp_path_factory.mktemp("serial") / "killed"
    _killed_serial_dir(serial_killed)
    procs, outs = {}, {}
    for world in (*SPAWNED, "kept"):
        size = 4 if world == "kept" else world
        out_dir = tmp_path_factory.mktemp(f"resilience_world{world}")
        shutil.copytree(serial_killed, out_dir / "serial_killed")
        outs[world] = out_dir
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, str(rank), str(size),
             str(out_dir / "store"), str(out_dir),
             *(["kept"] if world == "kept" else [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(size)]
    results = {"out": outs}
    mp = pytest.MonkeyPatch()
    try:
        _jax_env(mp)
        jax_dir = tmp_path_factory.mktemp("jax") / "killed"
        _jax_killed_dir(jax_dir)
        shutil.copytree(jax_dir, outs[2] / "jax_killed")
        (outs[2] / "jax_ready").touch()
        serial = {f"ref_{kind}": _serial_fit(kind, str(
            tmp_path_factory.mktemp(f"ref_{kind}") / "ck"))
            for kind in ("reg", "clf")}
        serial["jax_resumed"] = _serial_fit(ckpt=str(jax_dir))
        serial["plain_reg"] = _est().fit(_frame()).get_model_string()
        results["serial"] = serial
        logs = {}
        for world, ps in procs.items():
            logs[world] = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0]
                           for p in ps]
        for world, ps in procs.items():
            for rank, p in enumerate(ps):
                want = 1 if (world, rank) in ((4, 3), ("kept", 1)) else 0
                assert p.returncode == want, \
                    f"world {world} rank {rank}:\n{logs[world][rank]}"
            results[world] = [
                pickle.loads((outs[world] / f"rank{r}.pkl").read_bytes())
                if (outs[world] / f"rank{r}.pkl").exists() else {}
                for r in range(len(ps))]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {SPAWN_TIMEOUT_S} s")
    finally:
        mp.undo()
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


CKPT_FILES = ["checkpoint_2.txt", "checkpoint_2.txt.crc32",
              "checkpoint_4.txt", "checkpoint_4.txt.crc32",
              "checkpoint_6.txt", "checkpoint_6.txt.crc32",
              "checkpoint_meta.json"]


@pytest.mark.parametrize("kind", ["reg", "clf"])
@pytest.mark.parametrize("world", SPAWNED)
def test_checkpointed_fit_under_a_mesh_is_the_serial_fit(worlds, world,
                                                         kind):
    """Bitwise the serial checkpointed fit on every rank; only the
    mesh's first rank writes (7 files: 3 checkpoints, their digests and
    the fingerprint)."""
    want = worlds["serial"][f"ref_{kind}"]
    for rank, res in enumerate(worlds[world]):
        got = res[f"uninterrupted_{kind}"]
        assert got["model"] == want, rank
        assert got["hits"]["checkpoint.write"] == (7 if rank == 0 else 0)
        assert got["files"] == (CKPT_FILES if rank == 0 else None)


@pytest.mark.parametrize("kind", ["reg", "clf"])
@pytest.mark.parametrize("world", SPAWNED)
def test_killed_and_refit_resumes_at_rank_zeros_checkpoint(worlds, world,
                                                           kind):
    """Killed at the first iteration of segment 3, re-fit: every rank
    resumes at rank 0's checkpoint 4 (2 iterations left), though the
    other ranks name an empty directory, which stays empty; bitwise the
    serial fit."""
    want = worlds["serial"][f"ref_{kind}"]
    for rank, res in enumerate(worlds[world]):
        got = res[f"killed_{kind}"]
        assert "injected fault at 'gbdt.train_step'" in got["killed"]
        assert got["after_kill"] == (CKPT_FILES[:4] + CKPT_FILES[-1:]
                                     if rank == 0 else None)
        assert got["model"] == want, rank
        assert got["hits"]["gbdt.train_step"] == 2
        assert got["hits"]["checkpoint.write"] == (2 if rank == 0 else 0)
        assert got["refit_files"] == (CKPT_FILES if rank == 0 else [])


@pytest.mark.parametrize("world", SPAWNED)
def test_directories_cross_between_serial_and_mesh_fits(worlds, world):
    """A serial fit's directory resumes under the mesh, and a mesh fit's
    resumes serially, each bitwise the serial uninterrupted fit."""
    want = worlds["serial"]["ref_reg"]
    for rank, res in enumerate(worlds[world]):
        got = res["serial_dir"]
        assert got["model"] == want, rank
        assert got["hits"]["gbdt.train_step"] == 2
        if rank:
            assert got["files"] is None
    mesh_dir = worlds["out"][world] / "mesh_killed"
    assert _files(mesh_dir) == CKPT_FILES[:4] + CKPT_FILES[-1:]
    assert _serial_fit(ckpt=str(mesh_dir)) == want


def test_jax_directory_resumes_under_a_mesh(worlds):
    """The JAX package's checkpointed LightGBMRegressor, killed after
    checkpoint 4: its directory resumes under a 2-rank mesh bitwise the
    port's serial resume of the same directory (ROADMAP C17: every
    non-ranker fit's directory crosses)."""
    for res in worlds[2]:
        assert res["jax_dir"]["model"] == worlds["serial"]["jax_resumed"]
        assert res["jax_dir"]["hits"]["gbdt.train_step"] == 2


def _jax_recoveries(dp, monkeypatch, tmp_path):
    """The JAX package's ``fit_resilient`` records under the fault
    schedule of the ranks' ``resilient`` scenario, on its CPU mesh."""
    import jax

    from mmlspark_tpu.core import faults as jax_faults
    from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
    from mmlspark_tpu.models.gbdt.estimators import LightGBMRegressor
    from mmlspark_tpu.parallel import resilience as jax_res
    from mmlspark_tpu.parallel.mesh import (MeshConfig, axis_size,
                                            create_mesh)
    _jax_env(monkeypatch)
    jax_res.reset()
    est = LightGBMRegressor(numIterations=ITERS, numLeaves=7, maxBin=32,
                            seed=3)
    with jax_faults.injected("train.participant_loss", "raise", nth=5,
                             exc=jax_res.ParticipantLost(
                                 f"rank {dp - 1} lost")):
        out = jax_res.fit_resilient(
            est, JaxFrame(_cols()), checkpoint_dir=str(tmp_path / "ck"),
            checkpoint_interval=INTERVAL,
            mesh=create_mesh(MeshConfig(dp=dp), devices=jax.devices()[:dp]))
    return ([dataclasses.asdict(r) for r in out.recoveries],
            axis_size(out.mesh, "dp"), jax_res.recovery_count())


@pytest.mark.parametrize("world", SPAWNED)
def test_fit_resilient_shrinks_and_resumes_bitwise(worlds, world,
                                                   monkeypatch, tmp_path):
    """ParticipantLost at the first iteration of segment 3: dp shrinks
    to dp // 2, the ranks past it leave with ``model=None``, the kept
    ranks resume from rank 0's checkpoint 4 bitwise the serial
    uninterrupted fit; the records are the reference's."""
    want = worlds["serial"]["ref_reg"]
    keep = world // 2
    records = [{"cause": "ParticipantLost",
                "classification": "ParticipantLost", "dp_before": world,
                "dp_after": keep, "error": f"rank {world - 1} lost"}]
    if world == 4:
        # the reference's test_kill_mid_fit_dp_shrink_resume_bitwise
        # schedule, run by the JAX package
        assert _jax_recoveries(world, monkeypatch, tmp_path) == (
            records, keep, 1)
    for rank, res in enumerate(worlds[world]):
        got = res["resilient"]
        assert got["recoveries"] == records, rank
        assert got["recovery_count"] == 1
        if rank < keep:
            assert got["model"] == want, rank
            assert got["mesh"] == (keep, list(range(keep)),
                                   {"dp": rank, "fp": 0})
        else:
            assert got["model"] is None and got["mesh"] is None, rank
        assert got["files"] == (CKPT_FILES if rank == 0 else None)


@pytest.mark.parametrize("world", SPAWNED)
def test_armed_watchdog_keeps_the_mesh_fit_bits(worlds, world):
    """With the watchdog armed (MULT 4) and no stall, the meshed fit
    polls every collective and is still bitwise the serial fit."""
    for res in worlds[world]:
        got = res["armed"]
        assert got["model"] == worlds["serial"]["plain_reg"]
        assert got["stalls"] == 0
        assert got["last_collective"]["ranks"] == list(range(world))


def test_recovery_exhaustion_reraises(worlds):
    """A loss that keeps firing with no dp left to shrink to re-raises
    the original error on every rank."""
    for res in worlds[2]:
        assert res["exhausted"] == "flapping"


def test_real_participant_loss_recovers_bitwise(worlds):
    """Rank 3 exits mid-fit: ranks 0-2 see ParticipantLost at their next
    collective (gloo's closed socket), rank 2 leaves, ranks 0 and 1
    re-form and finish bitwise the serial uninterrupted fit."""
    ranks = worlds[4]
    assert "real_loss" not in ranks[3]
    want = worlds["serial"]["ref_reg"]
    for rank in range(3):
        got = ranks[rank]["real_loss"]
        [(cause, before, after, error)] = got["recoveries"]
        assert (cause, before, after) == ("ParticipantLost", 4, 2)
        assert "failed" in error and "ranks [0, 1, 2, 3]" in error
        if rank < 2:
            assert got["model"] == want and got["mesh_ranks"] == [0, 1]
        else:
            assert got["model"] is None and got["mesh_ranks"] is None
        assert got["wall_s"] < 60.0


def test_real_loss_inside_the_kept_slice_keeps_the_survivors(worlds):
    """Rank 1 of 4 exits mid-fit, inside the kept slice. Before the
    survivors agreed, rank 0 re-formed groups with the dead rank 1 and
    hung there past the group's timeout (ROADMAP C29). Now ranks 0, 2
    and 3 post to the store, wait ``WAIT_S`` for rank 1, agree that dp
    coordinate 1 is lost, and keep the first two survivors: ranks 0 and
    2 re-form a dp = 2 mesh and finish bitwise the serial uninterrupted
    checkpointed fit (rank 0's checkpoint 4 resumed), rank 3 leaves;
    none waits past the deadline."""
    ranks = worlds["kept"]
    assert ranks[1] == {}
    want = worlds["serial"]["ref_reg"]
    for rank in (0, 2, 3):
        got = ranks[rank]["kept_loss"]
        assert got["raised"] is None, got["raised"]
        [(cause, before, after, error)] = got["recoveries"]
        assert (cause, before, after) == ("ParticipantLost", 4, 2)
        assert "failed" in error and "ranks [0, 1, 2, 3]" in error
        if rank < 3:
            assert got["model"] == want, rank
            assert got["mesh"] == ([0, 2], {"dp": rank // 2, "fp": 0}, 2)
        else:
            assert got["model"] is None and got["mesh"] is None
        assert WAIT_S <= got["wall_s"] < WAIT_S + 30.0
        assert got["files"] == (CKPT_FILES if rank == 0 else None)


def test_real_hang_aborts_with_a_collective_stall(worlds):
    """Rank 1 sleeps 20 s before a collective: rank 0, waiting in it,
    raises TrainStalled collective-stall once its 1 s budget passes,
    within the reference test's slack, and leaves no watchdog thread."""
    got = worlds[2][0]["real_hang"]
    cls, label, budget, elapsed, where, last = got["stalled"]
    assert (cls, label, budget, where) == ("collective-stall", "gbdt.train",
                                           HANG_MIN_S, "collective")
    assert elapsed >= HANG_MIN_S
    assert got["wall_s"] < 15.0
    assert last["ranks"] == [0, 1]
    assert got["watchdog_threads"] == []
    # rank 1's own watchdog cut its sleep: no boundary was marked there
    other = worlds[2][1]["real_hang"]
    assert other["stalled"][0] == "backend-hang"
    assert other["wall_s"] < HANG_S
    assert other["watchdog_threads"] == []


def test_live_shrink_excludes_the_lost_rank(worlds):
    r0, r1 = (res["shrink_live"] for res in worlds[2])
    assert "is not in the surviving slice [1]" in r0
    assert r1 == ([1], {"dp": 0, "fp": 0}, 1, 2.0)


# --- in this process ------------------------------------------------------------

def test_shrink_mesh_sizes_are_the_reference_sizes(mesh8):
    """The reference's ``test_shrink_mesh`` cases on an 8 x 1 and a 4 x 2
    grid (``shrunk_ranks``: the surviving global ranks)."""
    from mmlspark_tpu.parallel.mesh import axis_size as jax_axis_size
    from mmlspark_tpu.parallel.mesh import shrink_mesh as jax_shrink
    from mmlspark_tpu_torch.parallel.mesh import (Mesh, shrink_mesh,
                                                  shrunk_ranks)
    m8 = Mesh(8, 1, {}, 0, "gloo", torch.device("cpu"))
    for kw, size in ((dict(keep_dp=4), 4), (dict(lost_ranks=[0, 7]), 6),
                     (dict(keep_dp=1), 1)):
        assert len(shrunk_ranks(m8, **kw)) == size == jax_axis_size(
            jax_shrink(mesh8, **kw), "dp")
    assert shrunk_ranks(m8, keep_dp=4) == [0, 1, 2, 3]
    assert shrunk_ranks(m8, lost_ranks=[0, 7]) == [1, 2, 3, 4, 5, 6]
    assert shrink_mesh(m8) is m8 and jax_shrink(mesh8) is mesh8
    assert shrink_mesh(m8, lost_ranks=[9]) is m8
    for bad in (dict(keep_dp=0), dict(lost_ranks=range(8))):
        with pytest.raises(ValueError, match="no surviving"):
            shrink_mesh(m8, **bad)
        with pytest.raises(ValueError, match="no surviving"):
            jax_shrink(mesh8, **bad)
    # fp = 2: a dp coordinate is a row of two ranks
    m42 = Mesh(4, 2, {}, 5, "gloo", torch.device("cpu"))
    assert m42.coords == {"dp": 2, "fp": 1}
    assert shrunk_ranks(m42, keep_dp=2) == [0, 1, 2, 3]
    assert shrunk_ranks(m42, lost_ranks=[1]) == [0, 1, 4, 5, 6, 7]
    with pytest.raises(ValueError, match="not in the surviving slice"):
        shrink_mesh(m42, keep_dp=2)


def test_survivors_agree_through_the_store():
    """``agree_survivors`` on a 4 x 1 mesh's ranks as threads over one
    store: rank 1 never posts, rank 3 posts after the first survivor's
    wait ended; every survivor gets the same coordinates, [0, 2] (rank 3
    too, so it leaves). With no rank lost the wait ends at once, and a
    2 x 2 grid loses the whole row of a lost rank."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel.mesh import Mesh
    from mmlspark_tpu_torch.parallel.resilience import agree_survivors

    def run(dp, fp, present, key, wait_s, late=()):
        store = dist.HashStore()
        got = {}

        def one(rank):
            if rank in late:
                time.sleep(wait_s + 0.5)
            got[rank] = agree_survivors(
                Mesh(dp, fp, {}, rank, "gloo", torch.device("cpu")), key,
                wait_s, store)

        threads = [threading.Thread(target=one, args=(r,)) for r in present]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            # bounded: a survivor that never decides fails the test
            t.join(timeout=wait_s + 30.0)
            assert not t.is_alive(), f"a survivor waited past {wait_s} s"
        return got, time.monotonic() - t0

    got, wall = run(4, 1, (0, 2, 3), "k1", 0.5, late=(3,))
    assert got == {0: [0, 2], 2: [0, 2], 3: [0, 2]}
    assert wall < 0.5 + 0.5 + 2.0
    got, wall = run(4, 1, range(4), "k2", 30.0)
    assert got == {r: [0, 1, 2, 3] for r in range(4)} and wall < 5.0
    got, _ = run(2, 2, (0, 1, 3), "k3", 0.3)
    assert got == {0: [0], 1: [0], 3: [0]}


def test_agreement_keys_and_the_watch():
    """``fit_resilient``'s store keys name the mesh's ranks and each
    rank's count of calls on them, held in the store: the ranks of one
    mesh get the same keys call after call, a new world's store starts
    again at call 0, and a shrunk mesh has keys of its own. The recovery
    watch (and so the polled collectives) is on only for a gloo mesh of
    more than one rank."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import resilience as R
    from mmlspark_tpu_torch.parallel.mesh import Mesh

    def mesh(rank, dp=4, backend="gloo", ranks=None):
        return Mesh(dp, 1, {}, rank, backend, torch.device("cpu"),
                    ranks=ranks)

    store = dist.HashStore()
    calls = [[R._call_key(mesh(r), store) for r in range(4)]
             for _ in range(2)]
    assert calls == [["mmlspark_tpu_torch/fit_resilient/0,1,2,3/0"] * 4,
                     ["mmlspark_tpu_torch/fit_resilient/0,1,2,3/1"] * 4]
    assert R._call_key(mesh(0), dist.HashStore()) == calls[0][0]
    assert R._call_key(mesh(2, 2, ranks=[0, 2]), store) == \
        "mmlspark_tpu_torch/fit_resilient/0,2/0"

    seen = {}
    for name, m in (("gloo4", mesh(0)), ("gloo1", mesh(0, 1, ranks=[0])),
                    ("nccl4", mesh(0, backend="nccl"))):
        with R._watching(m, store, "k"):
            seen[name] = (R.polling(), R.recovery_watch() is not None)
    assert seen == {"gloo4": (True, True), "gloo1": (False, False),
                    "nccl4": (False, False)}
    assert not R.polling() and R.recovery_watch() is None


def test_a_lost_store_gives_every_survivor_the_same_reason():
    """Where the rendezvous store itself is gone (a TCP store on a lost
    rank: its operations fail), no kept set can be formed and every
    survivor raises the same ``ParticipantLost``."""
    from mmlspark_tpu_torch.parallel.mesh import Mesh
    from mmlspark_tpu_torch.parallel.resilience import (ParticipantLost,
                                                        agree_survivors)

    class GoneStore:
        def __getattr__(self, name):
            def fail(*args):
                raise RuntimeError(f"{name}: Broken pipe")
            return fail

    said = set()
    for rank in (1, 2, 3):
        with pytest.raises(ParticipantLost) as ei:
            agree_survivors(Mesh(4, 1, {}, rank, "gloo",
                                 torch.device("cpu")), "k", 1.0, GoneStore())
        said.add(str(ei.value))
    assert said == {"fit_resilient: the survivors cannot agree on a kept "
                    "set: the rendezvous store is unreachable (was it held "
                    "by a lost rank?)"}


def test_learner_collectives_go_through_the_mesh_helpers():
    """Every collective of the learners is a marked, interruptible
    boundary: ``parallel_modes`` calls ``torch.distributed`` nowhere
    itself, only ``parallel.mesh``'s helpers."""
    import ast
    tree = ast.parse((ROOT / "mmlspark_tpu_torch" / "models" / "gbdt"
                      / "parallel_modes.py").read_text())
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names} | {
        n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in imported if m and "distributed" in m}
    calls = [n.func.attr for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and isinstance(n.func.value, ast.Name)]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id == "dist"]
    assert sum(c in ("all_reduce", "reduce_scatter", "all_gather")
               for c in calls) == 10


def test_rendezvous_that_never_answers_gives_up(monkeypatch):
    """With ``MMLSPARK_TORCH_WATCHDOG_INIT_S`` set, a rendezvous whose
    store never answers is cut at each attempt's budget and given up
    after ``DIST_INIT_TRIES`` attempts and the policy's backoff."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import mesh as M
    from mmlspark_tpu_torch.parallel import resilience as R
    budget = 0.5
    monkeypatch.setenv("MMLSPARK_TORCH_WATCHDOG_INIT_S", str(budget))
    R.reset()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        M.distributed_init(f"tcp://127.0.0.1:{port}", world_size=2, rank=1,
                           backend="gloo")
    wall = time.monotonic() - t0
    assert not dist.is_initialized()
    assert f"gave up after {M.DIST_INIT_TRIES}/{M.DIST_INIT_TRIES}" \
        in str(ei.value)
    # each attempt: the budget, the store's timeout at the same budget,
    # and the interrupt's landing; between attempts, backoffs of at most
    # 1.1 s and 2.2 s (RetryPolicy(base_delay=1.0, jitter=0.1))
    assert wall < M.DIST_INIT_TRIES * (2 * budget + 1.0) + 1.1 + 2.2
    R.reset()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:])

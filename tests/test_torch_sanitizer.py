"""The port's runtime sanitizer (``mmlspark_tpu_torch/core/sanitizer.py``)
held to the reference's unit tests (``tests/core/test_sanitizer.py``,
every case ported) and to the reference module itself: the same events
hash alike, the same NaN is named at the same boundary and leaf, and the
public names and exception classes match.

torch leaves are checked as numpy leaves are: one reduction per tensor,
one host read per boundary. The reference's wall-clock overhead bounds
become ratios against a baseline timed in the same test (best of
several trials) plus structural checks that the disabled path never
reaches the sanitizer's walkers, so a loaded host cannot fail them.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import sanitizer as ref_san
from mmlspark_tpu_torch.core import sanitizer as san
from mmlspark_tpu_torch.core.env import (SAN, SAN_DTYPE,
                                         SAN_LOCK_HOLD_MS,
                                         SAN_RECOMPILE_BUDGET,
                                         env_override)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _sanitizer_off():
    """Every test starts and ends disabled with clean state."""
    for mod in (san, ref_san):
        mod.disable()
        mod.reset()
        mod.set_recompile_budget(0)
        mod.set_lock_hold_budget_ms(0.0)
    yield
    for mod in (san, ref_san):
        mod.disable()
        mod.reset()
        mod.set_recompile_budget(0)
        mod.set_lock_hold_budget_ms(0.0)


def _best_ns(fn, reps, trials=5):
    """Best per-call time of ``fn`` over ``trials`` loops of ``reps``."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e9)
    return best


# --- the reference's surface ------------------------------------------------

def test_public_names_and_classes_mirror_the_reference():
    assert san.__all__ == ref_san.__all__
    assert san.KNOWN_COLLECTIVES == ref_san.KNOWN_COLLECTIVES
    for name in ("SanitizerError", "NonFiniteError", "CollectiveDivergence",
                 "RecompileBudgetExceeded", "LockOrderViolation",
                 "SanLockHoldWarning", "DtypeDrift"):
        mine, theirs = getattr(san, name), getattr(ref_san, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in theirs.__mro__], name


# --- disabled: strict no-op ----------------------------------------------

@pytest.mark.parametrize("x", [np.array([1.0, np.nan, np.inf]),
                               torch.tensor([1.0, float("nan")])],
                         ids=["numpy", "torch"])
def test_disabled_check_finite_passes_nan_through_identically(x):
    assert san.check_finite("boundary", x) is x


def test_disabled_recorder_and_counter_stay_empty():
    san.record_collective("psum", "dp", (4,), "float32")
    san.count_recompile("step")
    assert len(san.recorder()) == 0
    assert san.recompile_count() == 0
    assert san.step_boundary() == ""


def test_disabled_overhead_is_noise(monkeypatch):
    """The guard sits on hot paths: disabled, it never walks the value
    (structure), and it costs a small multiple of a plain passthrough
    call timed in the same test (the reference's absolute 5 us bound as
    a ratio a loaded host cannot break)."""
    def boom(*a, **k):
        raise AssertionError("walked while disabled")

    monkeypatch.setattr(san, "_float_leaves", boom)
    monkeypatch.setattr(san, "_dtype_signature", boom)
    x = torch.zeros(8)
    assert san.check_finite("bench", x) is x
    assert san.check_dtype_contract("bench", x) is x

    def passthrough(boundary, value):
        return value

    reps = 20_000
    base = _best_ns(lambda: passthrough("bench", x), reps)
    guarded = _best_ns(lambda: san.check_finite("bench", x), reps)
    assert guarded <= 10 * base + 200, (guarded, base)


# --- NaN/Inf guard --------------------------------------------------------

def test_nan_guard_names_boundary_and_counts():
    san.enable()
    bad = {"w": [np.ones(3), np.array([1.0, np.nan, np.inf, np.nan])]}
    with pytest.raises(san.NonFiniteError) as ei:
        san.check_finite("gbdt.train_scan.entry", bad)
    msg = str(ei.value)
    assert "graftsan" in msg
    assert "'gbdt.train_scan.entry'" in msg
    assert "2 NaN / 1 Inf" in msg
    assert "value['w'][1]" in msg


def test_nan_guard_on_torch_leaves_names_path_and_counts():
    san.enable()
    bad = {"raw": torch.zeros(5),
           "valid": (torch.ones(2, dtype=torch.float64),
                     torch.tensor([0.0, float("nan"), float("-inf")]))}
    with pytest.raises(san.NonFiniteError) as ei:
        san.check_finite("gbdt.train_scan.exit", bad)
    msg = str(ei.value)
    assert "'gbdt.train_scan.exit'" in msg
    assert "1 NaN / 1 Inf" in msg
    assert "value['valid'][1]" in msg and "(shape (3,))" in msg


def test_walk_order_first_bad_leaf_across_numpy_and_torch():
    """Mixed leaves: the first non-finite leaf in walk order is named,
    whichever kind it is."""
    san.enable()
    value = [torch.ones(2), np.array([np.inf]), torch.tensor([np.nan])]
    with pytest.raises(san.NonFiniteError, match=r"in value\[1\]"):
        san.check_finite("b", value)
    value = [torch.ones(2), torch.tensor([np.nan]), np.array([np.inf])]
    with pytest.raises(san.NonFiniteError, match=r"in value\[1\]"):
        san.check_finite("b", value)


def test_one_host_read_per_boundary(monkeypatch):
    """Every tensor leaf's flag is stacked and read once per device,
    never one read per leaf or element."""
    san.enable()
    reads = []
    real = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    value = {"a": torch.ones(100), "b": [torch.zeros(3, 4),
                                          torch.ones(7, dtype=torch.half)],
             "i": torch.arange(5)}
    assert san.check_finite("b", value) is value
    assert reads == [(3,)]


def test_guard_accepts_finite_and_non_float_leaves():
    san.enable()
    ok = {"i": np.arange(5), "f": np.ones(3), "s": "name",
          "n": None, "b": True, "t": (1.5, np.zeros(2)),
          "ti": torch.arange(4), "tb": torch.ones(2, dtype=torch.bool),
          "tu8": torch.zeros(3, dtype=torch.uint8), "tf": torch.ones(2)}
    assert san.check_finite("b", ok) is ok


def test_guard_skips_extension_dtypes():
    """A leaf whose dtype numpy cannot read (an object with a foreign
    ``dtype``) carries no float contract and passes."""
    class Foreign:
        dtype = object()

    san.enable()
    san.check_finite("b", {"key": Foreign(), "x": np.ones(2)})


def test_guard_catches_python_float_nan():
    san.enable()
    with pytest.raises(san.NonFiniteError):
        san.check_finite("b", {"lr": float("nan")})


def test_nan_text_matches_the_reference():
    """The same NaN input is named at the same boundary and leaf path,
    with the same counts, by both packages."""
    san.enable()
    ref_san.enable()
    bad = {"hist": [np.zeros(2, np.float32),
                    np.array([[np.nan, 1.0], [np.inf, np.nan]],
                             np.float32)]}
    torch_bad = {"hist": [torch.from_numpy(a) for a in bad["hist"]]}
    texts = []
    for mod, value in ((ref_san, bad), (san, bad), (san, torch_bad)):
        with pytest.raises(mod.NonFiniteError) as ei:
            mod.check_finite("gbdt.level_hist", value)
        texts.append(str(ei.value))
    head = texts[0].split(";")[0]
    assert "'gbdt.level_hist'" in head and "value['hist'][1]" in head
    assert "2 NaN / 1 Inf" in head
    for text in texts[1:]:
        assert text.split(";")[0] == head


# --- collective recorder / divergence cross-check -------------------------

def test_recorder_hash_is_order_and_content_sensitive():
    san.enable()
    a, b = san.CollectiveRecorder(), san.CollectiveRecorder()
    for r in (a, b):
        with san.use_recorder(r):
            san.record_collective("psum", "dp", (4, 2), "float32")
            san.record_collective("all_gather", "fp", (8,), "int32")
    assert a.sequence_hash() == b.sequence_hash()
    with san.use_recorder(b):
        san.record_collective("psum", "dp", (4, 2), "float32")
    assert a.sequence_hash() != b.sequence_hash()


def test_same_events_hash_alike_in_both_packages():
    """One protocol, one hash: events recorded in the port (torch shapes
    and dtypes) and in the reference (tuples and numpy dtypes) give the
    same tuples and the same ``sequence_hash``."""
    san.enable()
    ref_san.enable()
    mine, theirs = san.CollectiveRecorder(), ref_san.CollectiveRecorder()
    events = [("psum", "dp", (4, 16, 3), "float32"),
              ("reduce_scatter", "dp", (8, 3), "int64"),
              ("all_gather", ("dp", "fp"), (2,), "uint8"),
              ("ppermute", "sp", (1, 4, 2, 8), "bfloat16")]
    with san.use_recorder(mine):
        for op, axis, shape, dt in events:
            san.record_collective(op, axis, torch.Size(shape),
                                  getattr(torch, dt))
    with ref_san.use_recorder(theirs):
        for op, axis, shape, dt in events:
            ref_san.record_collective(op, axis, shape, dt)
    assert mine.events == theirs.events
    assert mine.sequence_hash() == theirs.sequence_hash()
    assert len(mine.sequence_hash()) == 16


def test_unknown_collective_kind_warns_once_and_records():
    san.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        san.record_collective("all_reduce_typo", "dp", (1,), "float32")
        san.record_collective("all_reduce_typo", "dp", (1,), "float32")
    assert len([w for w in caught if "unknown collective" in
                str(w.message)]) <= 1
    assert len(san.recorder()) == 2


def test_crosscheck_raises_naming_divergent_rank():
    san.enable()
    rank0, rank1 = san.CollectiveRecorder(), san.CollectiveRecorder()
    with san.use_recorder(rank0):
        san.record_collective("psum", "dp", (4,), "float32")
    with san.use_recorder(rank1):
        # the `if rank == 0: psum` class: rank 1 skipped the psum
        san.record_collective("all_gather", "dp", (4,), "float32")
    hashes = [rank0.sequence_hash(), rank1.sequence_hash()]
    with pytest.raises(san.CollectiveDivergence) as ei:
        san.crosscheck_hashes(hashes, tag="iteration 3")
    msg = str(ei.value)
    assert "rank 1" in msg and "'iteration 3'" in msg


def test_crosscheck_agreeing_ranks_pass():
    san.crosscheck_hashes(["abcd", "abcd", "abcd"])


def test_step_boundary_single_process_returns_local_hash():
    san.enable()
    san.record_collective("psum", "dp", (4,), "float32")
    h = san.step_boundary()
    assert h == san.recorder().sequence_hash() and len(h) == 16


def test_last_collective_is_the_active_recorders_last_event():
    san.enable()
    assert san.last_collective() is None
    san.record_collective("psum", "dp", torch.Size([3]), torch.float32)
    assert san.last_collective() == ("psum", "dp", (3,), "float32")


# --- recompilation budget -------------------------------------------------

def test_recompile_budget_raises_past_limit():
    san.enable()
    san.set_recompile_budget(2)
    san.count_recompile("step A")
    san.count_recompile("step B")
    with pytest.raises(san.RecompileBudgetExceeded) as ei:
        san.count_recompile("step C")
    msg = str(ei.value)
    assert "3 compilations" in msg and "budget of 2" in msg
    assert "step C" in msg
    assert "MMLSPARK_TORCH_SAN_RECOMPILE_BUDGET" in msg


def test_recompile_budget_zero_counts_only():
    san.enable()
    for i in range(10):
        san.count_recompile(f"step {i}")
    assert san.recompile_count() == 10


# --- env registration -----------------------------------------------------

def test_refresh_from_env_flips_enabled_and_budget():
    with env_override(SAN, "1"), env_override(SAN_RECOMPILE_BUDGET, "7"):
        san.refresh_from_env()
        assert san.enabled()
        for i in range(7):
            san.count_recompile(f"x{i}")   # budget 7: no raise
        with pytest.raises(san.RecompileBudgetExceeded):
            san.count_recompile("x7")
    san.refresh_from_env()
    assert not san.enabled()


def test_port_reads_its_own_knobs_only():
    """``MMLSPARK_TPU_SAN`` does not turn the port's sanitizer on."""
    with env_override("MMLSPARK_TPU_SAN", "1"), env_override(SAN, None):
        san.refresh_from_env()
        assert not san.enabled()
    with env_override(SAN_LOCK_HOLD_MS, "12.5"), env_override(SAN, "1"):
        san.refresh_from_env()
        assert san._lock_hold_budget_ms == 12.5
    san.refresh_from_env()
    assert san._lock_hold_budget_ms == 0.0


# --- lock-discipline recorder (graftlock runtime twin) ---------------------

@pytest.mark.lock_smoke
class TestSanLock:
    def test_abba_drill_aborts_attributed_with_san_on(self):
        """The seeded two-thread ABBA drill: t1 takes A then B, t2 takes
        B then A. With SAN on the second thread's inner acquire raises
        LockOrderViolation (naming thread, held set, both call sites)
        BEFORE blocking, so the drill finishes in well under a second
        instead of deadlocking."""
        san.enable()
        a = san.san_lock("drill.A")
        b = san.san_lock("drill.B")
        errors = []

        def t1():
            with a:
                with b:
                    pass

        def t2(ready):
            ready.wait(5.0)
            try:
                with b:
                    with a:       # reverse order: must be rejected
                        pass
            except san.LockOrderViolation as e:
                errors.append(e)

        t0 = time.perf_counter()
        ready = threading.Event()
        th1 = threading.Thread(target=t1, name="mmlspark-drill-1")
        th2 = threading.Thread(target=t2, args=(ready,),
                               name="mmlspark-drill-2")
        th1.start()
        th1.join(5.0)
        ready.set()
        th2.start()
        th2.join(5.0)
        assert not th1.is_alive() and not th2.is_alive()
        wall = time.perf_counter() - t0
        assert wall < 1.0, f"drill took {wall:.2f}s"
        assert len(errors) == 1
        err = errors[0]
        assert err.thread == "mmlspark-drill-2"
        assert tuple(err.held) == ("drill.B",)
        assert err.acquiring == "drill.A"
        msg = str(err)
        assert "ABBA" in msg
        assert "'drill.A'" in msg and "'drill.B'" in msg
        # both call sites are named: the earlier-recorded A->B order
        # and this acquire, all in this test file
        assert msg.count("test_torch_sanitizer.py") >= 2

    def test_abba_drill_completes_with_san_off(self):
        """SAN off (the default): the same sequential drill is two plain
        nested acquisitions and completes normally."""
        a = san.san_lock("offdrill.A")
        b = san.san_lock("offdrill.B")
        done = []

        def t1():
            with a:
                with b:
                    done.append("ab")

        def t2():
            with b:
                with a:
                    done.append("ba")

        th1 = threading.Thread(target=t1, name="mmlspark-offdrill-1")
        th1.start()
        th1.join(5.0)
        th2 = threading.Thread(target=t2, name="mmlspark-offdrill-2")
        th2.start()
        th2.join(5.0)
        assert done == ["ab", "ba"]
        assert san.lock_order_edges() == {}

    def test_consistent_order_records_edges_without_raising(self):
        san.enable()
        a = san.san_lock("ord.A")
        b = san.san_lock("ord.B")
        for _ in range(3):
            with a:
                with b:
                    pass
        edges = san.lock_order_edges()
        assert ("ord.A", "ord.B") in edges
        held_site, acq_site = edges[("ord.A", "ord.B")]
        assert "test_torch_sanitizer.py" in held_site
        assert "test_torch_sanitizer.py" in acq_site

    def test_hold_time_warning_names_acquire_site(self):
        san.enable()
        san.set_lock_hold_budget_ms(5.0)
        lk = san.san_lock("hold.slow")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with lk:
                time.sleep(0.03)
        hold = [w for w in caught
                if issubclass(w.category, san.SanLockHoldWarning)]
        assert len(hold) == 1
        msg = str(hold[0].message)
        assert "'hold.slow'" in msg
        assert "MMLSPARK_TORCH_SAN_LOCK_HOLD_MS=5" in msg
        assert "test_torch_sanitizer.py" in msg
        assert "GL012" in msg
        # under budget: no warning
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with lk:
                pass
        assert not [w for w in caught
                    if issubclass(w.category, san.SanLockHoldWarning)]

    def test_condition_wait_does_not_count_parked_time(self):
        """A Condition.wait parks without holding the lock, so a long
        timed wait under a small hold budget must not warn."""
        san.enable()
        san.set_lock_hold_budget_ms(5.0)
        cond = san.san_lock("hold.cond", kind="condition")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with cond:
                cond.wait(0.03)    # parked 30ms > 5ms budget: fine
        assert not [w for w in caught
                    if issubclass(w.category, san.SanLockHoldWarning)]

    def test_rlock_reentry_is_not_an_order_edge(self):
        san.enable()
        r = san.san_lock("reent.R", kind="rlock")
        with r:
            with r:
                pass
        assert san.lock_order_edges() == {}

    def test_disabled_acquire_overhead_within_budget(self, monkeypatch):
        """Disabled, a san_lock never looks at call sites or the order
        graph (structure), and its with-pass costs a small multiple of a
        raw ``threading.Lock``'s, timed in the same test (the reference's
        absolute 200 ns delta as a ratio)."""
        def boom(*a, **k):
            raise AssertionError("recorded while disabled")

        monkeypatch.setattr(san, "_call_site", boom)
        monkeypatch.setattr(san, "_check_order", boom)
        raw = threading.Lock()
        wrapped = san.san_lock("bench.disabled")

        def with_pass(lk):
            with lk:
                pass

        with_pass(wrapped)
        reps = 20_000
        base = _best_ns(lambda: with_pass(raw), reps)
        cost = _best_ns(lambda: with_pass(wrapped), reps)
        assert cost <= 10 * base + 500, (cost, base)

    def test_reset_clears_order_graph_and_held_state(self):
        san.enable()
        a = san.san_lock("reset.A")
        b = san.san_lock("reset.B")
        with a:
            with b:
                pass
        assert san.lock_order_edges()
        san.reset()
        assert san.lock_order_edges() == {}
        # after reset the reverse order is legal again (fresh graph)
        with b:
            with a:
                pass

    def test_san_lock_rejects_unknown_kind(self):
        with pytest.raises(ValueError, match="unknown kind"):
            san.san_lock("x", kind="semaphore")


# --- dtype contracts (graftdtype runtime twin) ------------------------------

@pytest.mark.dtype_smoke
class TestDtypeContract:
    def test_drift_drill_aborts_attributed_on_the_crossing(self):
        """Flip one leaf's width mid-run and the very next crossing
        raises, naming the boundary and the leaf."""
        san.enable()
        payload = {"scores": np.zeros(4, np.float32),
                   "bins": np.zeros(4, np.uint8)}
        san.check_dtype_contract("gbdt.train_scan.exit", payload)
        payload["scores"] = payload["scores"].astype(np.float16)
        with pytest.raises(san.DtypeDrift) as ei:
            san.check_dtype_contract("gbdt.train_scan.exit", payload)
        msg = str(ei.value)
        assert "'gbdt.train_scan.exit'" in msg
        assert "value['scores']" in msg
        assert "float32" in msg and "float16" in msg
        assert ei.value.boundary == "gbdt.train_scan.exit"
        assert ei.value.leaf == "value['scores']"
        assert ei.value.before == "float32"
        assert ei.value.after == "float16"

    def test_torch_leaf_drift_uses_numpy_names(self):
        """A torch leaf's signature is its dtype's numpy name, so a
        torch float32 and a numpy float32 are one contract, and a torch
        bfloat16 crossing after it drifts by name."""
        san.enable()
        san.check_dtype_contract("b", {"h": np.zeros(2, np.float32)})
        san.check_dtype_contract("b", {"h": torch.zeros(2)})
        assert san.dtype_contracts() == {"b": {"value['h']": "float32"}}
        with pytest.raises(san.DtypeDrift) as ei:
            san.check_dtype_contract(
                "b", {"h": torch.zeros(2, dtype=torch.bfloat16)})
        assert (ei.value.before, ei.value.after) == ("float32", "bfloat16")

    def test_disabled_arm_passes_drifted_values_through(self):
        a = {"w": np.zeros(3, np.float32)}
        b = {"w": torch.zeros(3, dtype=torch.float16)}
        assert san.check_dtype_contract("b", a) is a
        assert san.check_dtype_contract("b", b) is b
        assert san.dtype_contracts() == {}

    def test_matching_crossings_record_once_and_pass(self):
        san.enable()
        x = {"w": torch.ones(2), "i": torch.zeros(2, dtype=torch.int64)}
        assert san.check_dtype_contract("b", x) is x
        assert san.check_dtype_contract("b", x) is x
        assert san.dtype_contracts() == {
            "b": {"value['w']": "float32", "value['i']": "int64"}}

    def test_arity_tolerance_compares_common_leaves_only(self):
        san.enable()
        san.check_dtype_contract("probe", {"a": np.zeros(1, np.float32)})
        san.check_dtype_contract(
            "probe", {"a": np.zeros(1, np.float32),
                      "lbl": np.zeros(1, np.int8)})
        san.check_dtype_contract("probe", {"a": np.zeros(1, np.float32)})
        # ... but the joined leaf is now held to its width
        with pytest.raises(san.DtypeDrift):
            san.check_dtype_contract(
                "probe", {"lbl": np.zeros(1, np.int32)})

    def test_scalars_and_extension_leaves_carry_no_contract(self):
        san.enable()
        san.check_dtype_contract(
            "b", {"n": 3, "f": 0.5, "s": "x", "none": None,
                  "obj": object()})
        assert san.dtype_contracts() == {"b": {}}

    def test_reset_clears_contracts(self):
        san.enable()
        san.check_dtype_contract("b", np.zeros(1, np.float32))
        san.reset()
        assert san.dtype_contracts() == {}
        # fresh contract: the other width is legal again
        san.check_dtype_contract("b", np.zeros(1, np.float16))

    def test_env_gate_turns_only_the_dtype_check_off(self):
        with env_override(SAN, "1"), env_override(SAN_DTYPE, "0"):
            san.refresh_from_env()
            assert san.enabled()
            san.check_dtype_contract("b", np.zeros(1, np.float32))
            san.check_dtype_contract("b", np.zeros(1, np.float16))
            assert san.dtype_contracts() == {}
            # the rest of the sanitizer is still live
            with pytest.raises(san.NonFiniteError):
                san.check_finite("b", torch.tensor([float("nan")]))
        san.refresh_from_env()

    def test_disabled_call_overhead_within_budget(self):
        """Disabled, ``check_dtype_contract`` costs a small multiple of a
        no-op passthrough timed in the same test (the reference's
        absolute 200 ns delta as a ratio)."""
        payload = {"p": 1.0}

        def passthrough(boundary, value):
            return value

        reps = 20_000
        base = _best_ns(lambda: passthrough("bench", payload), reps)
        cost = _best_ns(lambda: san.check_dtype_contract("bench", payload),
                        reps)
        assert cost <= 10 * base + 200, (cost, base)

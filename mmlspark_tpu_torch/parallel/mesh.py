"""Process meshes and the collectives of the port's multi-device paths —
the port of ``mmlspark_tpu.parallel.mesh`` onto ``torch.distributed``.

The reference is single-controller: one process holds a
``jax.sharding.Mesh`` of devices, and XLA lays the collectives out. The
port is multi-controller: each rank is one process (started by
``torchrun`` or ``torch.multiprocessing``), every rank makes the same
calls with the same arguments, and a :class:`Mesh` arranges the ranks of
the default process group in a ``dp`` x ``fp`` grid with a process group
per row and column:

  - ``dp`` — data parallel: rows sharded; histogram sums reduced over it
    (LightGBM ``data_parallel`` and ``voting_parallel``);
  - ``fp`` — feature parallel: columns sharded; split winners and row
    routing shared over it (LightGBM ``feature_parallel``).

Rank ``r`` sits at ``(r // fp, r % fp)``, as the reference reshapes its
device list. The sequence-parallel group of the attention ops is
:func:`sequence_group`.

The collective helpers (:func:`all_reduce`, :func:`reduce_scatter`,
:func:`all_gather`) take a tensor on the fit's device and return one
there. Where the tensors live is the backend's rule: NCCL reduces CUDA
tensors in place on the card; gloo reduces CPU tensors, so a CUDA tensor
goes through an explicit copy to the host and back (two ranks sharing
one card can only use gloo: NCCL refuses two ranks on one device). The
helpers add the bytes each rank receives to ``Mesh.bytes`` under a tag,
so a caller can hold its traffic against a model of it. Each is a
``collective`` boundary of the train-step watchdog
(``parallel/resilience.py``): it passes the fault points ``allreduce``
and ``mesh.collective_hang``, and while a watchdog is armed or a
``fit_resilient`` fit runs on a gloo mesh of more than one rank it
issues the collective with ``async_op=True`` and waits interruptibly
(gloo: on a waiter thread; NCCL: polling the work), so that a stall can
be interrupted and a rank blocked on a peer that went on to recover
sees that peer's flag in the rendezvous store; otherwise it waits
directly (NCCL: it only queues the work).
A collective that the backend fails (gloo: a peer's socket closed, a
timeout), or whose wait sees the flag, raises
:class:`parallel.resilience.ParticipantLost` with the reason and the
group's ranks. Each helper reports its collective (op, axis, shape,
dtype) to the runtime sanitizer's recorder (``core/sanitizer.py``; a
no-op while it is off), in the reference's names: ``psum`` / ``pmax`` /
``pmin``, ``reduce_scatter``, ``all_gather``, ``pbroadcast``.

:func:`shrink_mesh` re-forms a mesh on a surviving slice of its ``dp``
axis with process groups among the survivors only
(``use_local_synchronization``), so departed and dead ranks need not
call; a mesh's own group (``Mesh.group``) spans its ranks, and nothing
of a fit on a shrunk mesh touches the default (world) group.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.core import sanitizer
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.parallel import resilience

DATA_AXIS = "dp"
FEATURE_AXIS = "fp"
SEQUENCE_AXIS = "sp"
# how often a gloo collective's interruptible wait looks at
# fit_resilient's recovery flag (``resilience.recovery_watch``), seconds
_WATCH_S = 0.01
# rendezvous attempts of ``distributed_init`` in all (the reference's
# default for ``MMLSPARK_TPU_DIST_INIT_RETRIES``)
DIST_INIT_TRIES = 3


@dataclass
class MeshConfig:
    """Declarative mesh shape; -1 means "all remaining ranks" (the
    reference's ``MeshConfig`` and its ``resolve`` rules). The port's
    GBDT mesh has ``dp`` and ``fp`` axes; ``mp`` and ``sp`` must be 1 in
    it (the attention ops take their own group, :func:`sequence_group`)."""

    dp: int = -1
    fp: int = 1
    mp: int = 1
    sp: int = 1

    def resolve(self, num_devices: int) -> Tuple[int, int, int, int]:
        dp, fp, mp, sp = self.dp, self.fp, self.mp, self.sp
        fixed = max(fp, 1) * max(mp, 1) * max(sp, 1)
        if dp == -1:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by "
                    f"fp*mp*sp={fixed}")
            dp = num_devices // fixed
        if dp * fp * mp * sp != num_devices:
            raise ValueError(
                f"mesh {dp}x{fp}x{mp}x{sp} != {num_devices} devices")
        return dp, fp, mp, sp


class Mesh:
    """Ranks of the default process group as a ``dp`` x ``fp`` grid:
    ``ranks`` (their global ranks in grid order: rank ``ranks[i * fp +
    j]`` sits at ``(i, j)``; every rank of the world for
    :func:`create_mesh`), this rank's global rank and coordinates, the
    process group of each axis through it, the group of every rank of
    the mesh (``group``), and the device its collectives run on
    (``comm_device``: the CUDA device under NCCL, the CPU under gloo).
    ``bytes``: {tag: bytes this rank received from the collectives made
    with that tag}."""

    def __init__(self, dp: int, fp: int, groups: Dict[str, object],
                 rank: int, backend: str, comm_device: torch.device,
                 ranks: Optional[Sequence[int]] = None, group=None):
        self.shape = {DATA_AXIS: dp, FEATURE_AXIS: fp}
        self.ranks: List[int] = (list(ranks) if ranks is not None
                                 else list(range(dp * fp)))
        self.rank = rank
        at = self.ranks.index(rank)
        self.coords = {DATA_AXIS: at // fp, FEATURE_AXIS: at % fp}
        self.groups = groups
        self.group = group
        self.backend = backend
        self.comm_device = comm_device
        self.bytes: Dict[str, int] = {}

    @property
    def first_rank(self) -> int:
        """The global rank at ``(0, 0)``: the mesh's writer of shared
        state (checkpoints) and the source of its broadcasts."""
        return self.ranks[0]

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[FEATURE_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape[DATA_AXIS]}, "
                f"fp={self.shape[FEATURE_AXIS]}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _require_initialized() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "process group (distributed_init, or "
                           "torch.distributed.init_process_group)")


def create_mesh(config: Optional[MeshConfig] = None,
                device: Optional[torch.device] = None) -> Mesh:
    """A :class:`Mesh` over every rank of the default process group.
    Every rank must call it, with the same ``config`` (default: ``dp``
    over every rank), in the same order as its other group creations:
    it makes one process group per ``dp`` column and per ``fp`` row.
    ``device``: where an NCCL mesh's collectives run (default the current
    CUDA device); a gloo mesh's run on the CPU."""
    _require_initialized()
    world = dist.get_world_size()
    dp, fp, mp, sp = (config or MeshConfig()).resolve(world)
    if mp != 1 or sp != 1:
        raise ValueError(f"the GBDT mesh has dp and fp axes only; got "
                         f"mp={mp}, sp={sp}")
    rank = dist.get_rank()
    groups: Dict[str, object] = {}
    # every rank creates every group, in one order
    for j in range(fp):
        g = dist.new_group([i * fp + j for i in range(dp)])
        if rank % fp == j:
            groups[DATA_AXIS] = g
    for i in range(dp):
        g = dist.new_group([i * fp + j for j in range(fp)])
        if rank // fp == i:
            groups[FEATURE_AXIS] = g
    backend = str(dist.get_backend())
    if backend == "nccl":
        comm = (device if device is not None
                else torch.device("cuda", torch.cuda.current_device()))
    else:
        comm = torch.device("cpu")
    return Mesh(dp, fp, groups, rank, backend, torch.device(comm),
                ranks=range(world), group=dist.group.WORLD)


def shrunk_ranks(mesh: Mesh, keep_dp: Optional[int] = None,
                 lost_ranks: Sequence[int] = ()) -> Optional[List[int]]:
    """The global ranks, in grid order, of :func:`shrink_mesh`'s mesh
    (None where nothing shrinks); it makes no group."""
    dp, fp = mesh.shape[DATA_AXIS], mesh.shape[FEATURE_AXIS]
    if lost_ranks:
        lost = set(lost_ranks)
        surviving = [i for i in range(dp) if i not in lost]
    else:
        surviving = list(range(dp if keep_dp is None else keep_dp))
    if not surviving:
        raise ValueError("no surviving dp ranks to re-form the mesh on")
    if len(surviving) == dp:
        return None
    if surviving[-1] >= dp:
        raise ValueError(f"keep_dp={keep_dp} is past the mesh's dp axis "
                         f"of {dp}")
    return [mesh.ranks[i * fp + j] for i in surviving for j in range(fp)]


def shrink_mesh(mesh: Mesh, keep_dp: Optional[int] = None,
                lost_ranks: Sequence[int] = ()) -> Mesh:
    """Re-form ``mesh`` on a surviving slice of its ``dp`` axis: the
    first ``keep_dp`` dp coordinates, or all but the dp coordinates in
    ``lost_ranks`` (the reference's ``shrink_mesh`` semantics). Returns
    ``mesh`` itself when nothing shrinks; raises ``ValueError`` when no
    dp coordinate survives, or when this rank is not in the surviving
    slice (a departing rank leaves the fit; it does not call).

    The surviving ranks keep their global ranks and ``fp``; the new
    mesh's groups (its own, each ``dp`` column's and each ``fp`` row's
    through this rank) are made among them only
    (``new_group(..., use_local_synchronization=True)``), so departed
    and dead ranks need not call. Every surviving rank calls it with the
    same arguments, in the same order as its other group creations: a
    group's name derives from its ranks and from how many groups each
    member already holds. The fit that follows resumes from the last
    segment checkpoint: the fingerprint leaves out the mesh."""
    ranks = shrunk_ranks(mesh, keep_dp, lost_ranks)
    if ranks is None:
        return mesh
    fp = mesh.shape[FEATURE_AXIS]
    if mesh.rank not in ranks:
        raise ValueError(f"rank {mesh.rank} is not in the surviving slice "
                         f"{ranks}: it leaves the fit")
    at = ranks.index(mesh.rank)
    i, j = at // fp, at % fp
    new_dp = len(ranks) // fp

    def group(members):
        return dist.new_group(members, use_local_synchronization=True)

    whole = group(ranks)
    groups = {DATA_AXIS: group([ranks[r * fp + j] for r in range(new_dp)]),
              FEATURE_AXIS: group([ranks[i * fp + c] for c in range(fp)])}
    return Mesh(new_dp, fp, groups, mesh.rank, mesh.backend,
                mesh.comm_device, ranks=ranks, group=whole)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.coords[axis]


def process_index() -> int:
    """This process's rank (0 without a process group): the reference's
    main-worker election key, leader == process 0."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def is_multiprocess() -> bool:
    return process_count() > 1


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> None:
    """Join (or bootstrap) the default process group: the rendezvous of
    the reference's ``distributed_init``, over
    ``torch.distributed.init_process_group``. ``init_method`` (a
    ``tcp://host:port`` or ``file://`` URL), ``world_size`` and ``rank``
    default from ``torchrun``'s environment (``env://``: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK); ``backend`` defaults to NCCL where a
    card is visible, else gloo. A rendezvous that fails transiently (a
    coordinator still coming up) is tried ``DIST_INIT_TRIES`` times in
    all through ``core.retries``; misuse (bad arguments, a second init)
    is not retried. ``MMLSPARK_TORCH_WATCHDOG_INIT_S`` > 0 bounds each
    attempt (``resilience.stall_guard``, and the attempt's
    ``init_process_group`` timeout where ``timeout_s`` is not given): a
    rendezvous that never answers raises ``TrainStalled`` (or the
    store's timeout) and is retried like any transient failure."""
    from mmlspark_tpu_torch.core.retries import RetryPolicy, with_retries

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    budget = resilience.init_budget_s()
    if timeout_s is None and budget > 0:
        # a store that never answers waits in C++, where no interrupt
        # lands: its own timeout is what cuts the attempt
        timeout_s = budget
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)

    def attempt():
        with resilience.stall_guard("distributed.init", budget):
            fault_point("distributed.init")
            dist.init_process_group(**kwargs)

    def should_retry(e: BaseException) -> bool:
        # misuse (bad arguments, a second init) is not transient
        if isinstance(e, (ValueError, TypeError)):
            return False
        msg = str(e).lower()
        return "twice" not in msg and "already" not in msg

    with_retries(attempt,
                 policy=RetryPolicy(max_attempts=DIST_INIT_TRIES,
                                    base_delay=1.0,
                                    max_delay=10.0),
                 should_retry=should_retry, describe="distributed.init")


# ---------------------------------------------------------------------------
# Collectives on a mesh axis
# ---------------------------------------------------------------------------

_last_collective: Optional[Dict[str, Any]] = None


def last_collective() -> Optional[Dict[str, Any]]:
    """The last collective issued while a watchdog was armed (name, tag,
    axis, group ranks), for the watchdog's progress report."""
    return _last_collective


def _to_comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` on the device the backend reduces on (a copy where it lies
    elsewhere: a CUDA tensor under gloo), contiguous."""
    if t.device != mesh.comm_device:
        resilience.wait_for_device(t.device)
    return t.to(mesh.comm_device).contiguous()


class _Waiter:
    """A daemon thread that waits on the gloo works handed to it, one at
    a time, while the caller's thread stays free to take an interrupt or
    look at a flag. ``work.wait()`` leaves the interpreter lock, and it
    is what runs a gloo reduce-scatter at all (its work says done only
    once waited on). A caller that gives up on a work hands the thread
    ``None``: it ends after that work does, and the next wait starts a
    new thread."""

    def __init__(self) -> None:
        self.jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._loop, name="mmlspark-mesh-wait",
                         daemon=True).start()

    def _loop(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            work, done, failed = job
            try:
                work.wait()
            except BaseException as e:  # handed to the caller
                failed.append(e)
            done.set()


_waiter: Optional[_Waiter] = None


def _wait_gloo(work: Any, watch: Optional[Callable[[], bool]]) -> bool:
    """Wait for a gloo ``work`` on the waiter thread, looking at
    ``watch`` every ``_WATCH_S`` seconds: False once the work is done
    (its error re-raised), True where ``watch`` said a peer began
    recovering (the work is given up). An interrupt that lands here
    gives the work up too."""
    global _waiter
    if _waiter is None:
        _waiter = _Waiter()
    done, failed = threading.Event(), []
    _waiter.jobs.put((work, done, failed))
    finished = False
    try:
        while not done.wait(_WATCH_S):
            if watch is not None and watch():
                return True
        finished = True
    finally:
        if not finished:
            _waiter.jobs.put(None)
            _waiter = None
    if failed:
        raise failed[0]
    return False


def _run(mesh: Mesh, axis: str, what: str, tag: str,
         issue: Callable[[bool], Any],
         record: Optional[Tuple[str, torch.Tensor]] = None) -> None:
    """Run one collective on ``axis``'s group (``"mesh"``: every rank of
    the mesh): ``issue(async_op)`` makes the call. ``record``: (the
    sanitizer's name of the op, its input tensor), reported to
    ``sanitizer.record_collective`` with the axis, shape and dtype before
    the call (a no-op unless the sanitizer is on); None for the
    sanitizer's own hash gather. A ``collective`` boundary with the fault
    points ``allreduce`` and ``mesh.collective_hang``. Under an armed watchdog or a resilient fit
    on gloo (``resilience.polling``) the wait can be interrupted: gloo's
    work is waited on by :class:`_Waiter`'s thread while this one looks
    at the resilient fit's recovery flag, NCCL's is polled. A backend
    failure, or the flag, raises ``ParticipantLost``."""
    global _last_collective
    if record is not None:
        op, t = record
        sanitizer.record_collective(op, axis, t.shape, t.dtype)
    fault_point("allreduce")
    prev = resilience.mark_boundary(
        "collective", lambda: f"{what} ({tag}) over {axis}, ranks "
                              f"{_ranks(mesh, axis)}")
    try:
        fault_point("mesh.collective_hang")
        failed = None
        try:
            if resilience.polling():
                if resilience.armed():
                    _last_collective = {"name": what, "tag": tag,
                                        "axis": axis,
                                        "ranks": _ranks(mesh, axis)}
                work = issue(True)
                if mesh.backend == "gloo":
                    if _wait_gloo(work, resilience.recovery_watch()):
                        failed = "a peer began recovering from a loss"
                else:
                    pause = 5e-5
                    while not work.is_completed():
                        time.sleep(pause)
                        pause = min(2 * pause, 1e-3)
                    work.wait()
            else:
                issue(False)
        except RuntimeError as e:
            raise resilience.ParticipantLost(
                f"{what} ({tag}) over the {axis} group of ranks "
                f"{_ranks(mesh, axis)} failed: {e}") from e
        if failed is not None:
            raise resilience.ParticipantLost(
                f"{what} ({tag}) over the {axis} group of ranks "
                f"{_ranks(mesh, axis)} failed: {failed}")
    finally:
        resilience.restore_boundary(prev)


def _group(mesh: Mesh, axis: str):
    """The process group of ``axis`` (``"mesh"``: every rank of it)."""
    return mesh.group if axis == "mesh" else mesh.groups[axis]


def _ranks(mesh: Mesh, axis: str) -> List[int]:
    return list(dist.get_process_group_ranks(_group(mesh, axis)))


def _count(mesh: Mesh, tag: str, t: torch.Tensor) -> None:
    mesh.bytes[tag] = mesh.bytes.get(tag, 0) + t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
# the sanitizer's (the reference's) names of the reductions
_SAN_OPS = {"sum": "psum", "max": "pmax", "min": "pmin"}


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
               op: str = "sum", tag: str = "other") -> torch.Tensor:
    """``t`` reduced (``op``: sum, max or min) over the ranks of ``axis``,
    on ``t``'s device. Integer sums and maxima are the same in any
    order; a float sum is not, so the port's learners reduce integers or
    bits."""
    buf = _to_comm(mesh, t)
    if buf is t:
        buf = t.clone()
    _run(mesh, axis, "all_reduce", tag, lambda a: dist.all_reduce(
        buf, op=_OPS[op], group=mesh.groups[axis], async_op=a),
        record=(_SAN_OPS[op], buf))
    _count(mesh, tag, buf)
    return buf.to(t.device)


def _collective(name: str, old: str):
    """The newer ``*_single`` spelling of a collective where this torch
    has it, else the older ``*_into_tensor`` / ``*_tensor`` one."""
    return getattr(dist, name, None) or getattr(dist, old)


def reduce_scatter(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
                   tag: str = "other") -> torch.Tensor:
    """The sum over the ranks of ``axis`` of ``t`` (its first dimension a
    multiple of the axis size), of which this rank keeps the block of
    ``t.shape[0] / size`` rows at its coordinate."""
    size = mesh.shape[axis]
    if t.shape[0] % size:
        raise ValueError(f"reduce_scatter needs dim 0 ({t.shape[0]}) "
                         f"divisible by the {axis} axis ({size})")
    buf = _to_comm(mesh, t)
    block = t.shape[0] // size
    out = torch.empty((block, *t.shape[1:]), dtype=t.dtype,
                      device=buf.device)
    fn = _collective("reduce_scatter_single", "reduce_scatter_tensor")
    _run(mesh, axis, "reduce_scatter", tag,
         lambda a: fn(out, buf, group=mesh.groups[axis], async_op=a),
         record=("reduce_scatter", buf))
    _count(mesh, tag, out)
    return out.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
               tag: str = "other", record: bool = True) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) along a new first block:
    ``(size * t.shape[0], ...)`` in rank order on ``axis`` (``"mesh"``:
    every rank of the mesh, in its rank order). ``record=False`` keeps
    it out of the sanitizer's collective sequence (the sanitizer's own
    hash gather)."""
    buf = _to_comm(mesh, t)
    size = mesh.size if axis == "mesh" else mesh.shape[axis]
    out = torch.empty((size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=buf.device)
    fn = _collective("all_gather_single", "all_gather_into_tensor")
    _run(mesh, axis, "all_gather", tag,
         lambda a: fn(out, buf, group=_group(mesh, axis), async_op=a),
         record=("all_gather", buf) if record else None)
    _count(mesh, tag, out)
    return out.to(t.device)


def broadcast_object(mesh: Mesh, obj: Any = None, tag: str = "object"
                     ) -> Any:
    """``obj`` of the mesh's first rank, on every rank of the mesh
    (pickled; the other ranks' ``obj`` is ignored), over the mesh's own
    group: a length, then the bytes. A ``collective`` boundary like the
    other helpers; no rank returns before the first rank has sent, so it
    also orders what the first rank did before it."""
    src = mesh.first_rank
    leader = mesh.rank == src
    payload = pickle.dumps(obj) if leader else b""
    size = torch.tensor([len(payload)], dtype=torch.int64,
                        device=mesh.comm_device)
    _run(mesh, "mesh", "broadcast", tag, lambda a: dist.broadcast(
        size, src, group=mesh.group, async_op=a),
        record=("pbroadcast", size))
    n = int(size.item())
    data = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(
        mesh.comm_device) if leader else
        torch.empty(n, dtype=torch.uint8, device=mesh.comm_device))
    _run(mesh, "mesh", "broadcast", tag, lambda a: dist.broadcast(
        data, src, group=mesh.group, async_op=a),
        record=("pbroadcast", data))
    _count(mesh, tag, data)
    return obj if leader else pickle.loads(data.cpu().numpy().tobytes())


def sequence_group(group: Optional[dist.ProcessGroup] = None
                   ) -> Tuple[dist.ProcessGroup, int, int]:
    """``(group, rank, size)`` of the sequence-parallel group: ``group``,
    or the default (world) group. Raises when ``torch.distributed`` is
    not initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("sequence parallelism needs an initialized "
                           "torch.distributed process group")
    group = dist.group.WORLD if group is None else group
    return group, dist.get_rank(group), dist.get_world_size(group)

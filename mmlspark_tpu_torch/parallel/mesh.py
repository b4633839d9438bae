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
so a caller can hold its traffic against a model of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
FEATURE_AXIS = "fp"
SEQUENCE_AXIS = "sp"
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
    """The ranks of the default process group as a ``dp`` x ``fp`` grid:
    this rank's coordinates, the process group of each axis through it,
    and the device its collectives run on (``comm_device``: the CUDA
    device under NCCL, the CPU under gloo). ``bytes``: {tag: bytes this
    rank received from the collectives made with that tag}."""

    def __init__(self, dp: int, fp: int, groups: Dict[str, object],
                 rank: int, backend: str, comm_device: torch.device):
        self.shape = {DATA_AXIS: dp, FEATURE_AXIS: fp}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // fp, FEATURE_AXIS: rank % fp}
        self.groups = groups
        self.backend = backend
        self.comm_device = comm_device
        self.bytes: Dict[str, int] = {}

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
    return Mesh(dp, fp, groups, rank, backend, torch.device(comm))


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
    is not retried."""
    from mmlspark_tpu_torch.core.faults import fault_point
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
    if timeout_s is not None:
        kwargs["timeout"] = timedelta(seconds=timeout_s)

    def attempt():
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

def _to_comm(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` on the device the backend reduces on (a copy where it lies
    elsewhere: a CUDA tensor under gloo), contiguous."""
    return t.to(mesh.comm_device).contiguous()


def _count(mesh: Mesh, tag: str, t: torch.Tensor) -> None:
    mesh.bytes[tag] = mesh.bytes.get(tag, 0) + t.numel() * t.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
               op: str = "sum", tag: str = "other") -> torch.Tensor:
    """``t`` reduced (``op``: sum, max or min) over the ranks of ``axis``,
    on ``t``'s device. Integer sums and maxima are the same in any
    order; a float sum is not, so the port's learners reduce integers or
    bits."""
    buf = _to_comm(mesh, t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.groups[axis])
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
    out = torch.empty((t.shape[0] // size, *t.shape[1:]), dtype=t.dtype,
                      device=buf.device)
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, buf, group=mesh.groups[axis])
    _count(mesh, tag, out)
    return out.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
               tag: str = "other") -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) along a new first block:
    ``(size * t.shape[0], ...)`` in rank order on ``axis``."""
    buf = _to_comm(mesh, t)
    size = mesh.shape[axis]
    out = torch.empty((size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=buf.device)
    _collective("all_gather_single", "all_gather_into_tensor")(
        out, buf, group=mesh.groups[axis])
    _count(mesh, tag, out)
    return out.to(t.device)


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

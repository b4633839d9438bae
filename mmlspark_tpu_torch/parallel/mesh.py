"""The sequence-parallel process group of the long-context attention ops.

Port of the one convention of ``mmlspark_tpu.parallel.mesh`` that the
attention plane uses: the ``sp`` axis. On the TPU it is an axis of a
``jax.sharding.Mesh``; here it is a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU), by default the whole world. The
caller initializes the group (``torch.distributed.init_process_group``
with its own address, world size and rank).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

SEQUENCE_AXIS = "sp"


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

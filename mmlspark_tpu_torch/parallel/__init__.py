"""The port's parallel plane: meshes and collectives over
``torch.distributed`` (``mesh``), training resilience (``resilience``),
attention (``attention``, ``flash``), sharded scoring (``shard_rules``)
and host-side prefetch (``prefetch``)."""

from mmlspark_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    create_mesh,
    shrink_mesh,
)
from mmlspark_tpu_torch.parallel.resilience import (  # noqa: F401
    ParticipantLost,
    TrainStalled,
    fit_resilient,
)

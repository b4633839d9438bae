"""Model serving over HTTP and the model lifecycle — the port's copy of
the serving part of the JAX package's ``io`` package (Spark Serving's
head-node, distributed and continuous modes, SURVEY.md §3.5): servers
with hot swaps, drain and kill, the serving fleet with its supervisor
and client, and the streaming refresh loop."""

from mmlspark_tpu_torch.io.fleet import FleetSupervisor
from mmlspark_tpu_torch.io.refresh import (
    RefreshController,
    RefreshResult,
    StreamBuffer,
)
from mmlspark_tpu_torch.io.serving import (
    ContinuousServingServer,
    FleetClient,
    ServingFleet,
    ServingServer,
    SwapFailed,
    serve_continuous,
    serve_distributed,
    serve_pipeline,
)

__all__ = ["ServingServer", "ServingFleet", "ContinuousServingServer",
           "FleetClient", "FleetSupervisor", "SwapFailed",
           "RefreshController", "RefreshResult", "StreamBuffer",
           "serve_pipeline", "serve_distributed", "serve_continuous"]

"""Model serving over HTTP — the port's copy of the serving part of the
JAX package's ``io`` package (Spark Serving's head-node and continuous
modes, SURVEY.md §3.5). The serving fleet, the streaming refresh loop
and the model lifecycle around them are ROADMAP A6d: their names raise
``NotImplementedError`` here."""

from mmlspark_tpu_torch.io.serving import (  # noqa: F401
    ContinuousServingServer,
    FleetClient,
    ServingFleet,
    ServingServer,
    serve_continuous,
    serve_distributed,
    serve_pipeline,
)

# names of the JAX package's io/fleet.py and io/refresh.py
_A6D_NAMES = ("FleetSupervisor", "RefreshController", "RefreshResult",
              "StreamBuffer", "SwapFailed")

__all__ = ["ServingServer", "ContinuousServingServer", "ServingFleet",
           "FleetClient", "serve_pipeline", "serve_continuous",
           "serve_distributed"]


def __getattr__(name):
    if name in _A6D_NAMES:
        raise NotImplementedError(
            f"{name} is not in the port yet (ROADMAP A6d (serving fleet "
            "and lifecycle))")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

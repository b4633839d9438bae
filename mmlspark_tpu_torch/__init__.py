"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX one, grown slice by slice. It imports
``torch`` and numpy only: nothing of JAX and nothing of ``mmlspark_tpu``
(host code it needs is kept as its own copy). Layout mirrors the JAX
package so each counterpart is easy to find:

  - ``core``                      DataFrame, Params, Pipeline, save / load
  - ``ops.binning``               BinMapper (numeric quantile binning)
  - ``models.gbdt.trainer``       TrainConfig / train (depthwise GBDT)
  - ``models.gbdt.booster``       BoosterArrays scoring
  - ``models.gbdt.estimators``    LightGBMClassifier (binary, multiclass) /
                                  LightGBMRegressor / LightGBMRanker
                                  (fit / transform over ``DataFrame``)
  - ``models.gbdt.hist_cuda``     the level-histogram kernels' wrappers
  - ``io.serving``                ServingServer / ContinuousServingServer
                                  (HTTP serving, the binned data plane,
                                  hot swaps, drain / kill), ServingFleet,
                                  FleetClient
  - ``io.fleet``                  FleetSupervisor (heartbeats, restarts,
                                  autoscaling, fleet-wide swaps)
  - ``io.refresh``                StreamBuffer / RefreshController (the
                                  streaming refresh loop: drift, refit on
                                  the card, hot swap)
  - ``parallel.attention``        dense / blockwise / fused attention, ring
                                  and Ulysses over ``torch.distributed``
  - ``parallel.flash``            the flash-attention kernel's wrapper
  - ``csrc/``                     hand-written CUDA kernels (sm_90a)
  - ``native.bindings``           builds ``csrc/*.cu`` with nvcc, loads them

Public entry points run on the CUDA card unless the caller passes
``device="cpu"`` (stages: ``set_device("cpu")``); without a card they
raise rather than fall back.
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.core.dataframe import DataFrame  # noqa: F401
from mmlspark_tpu_torch.core.pipeline import (  # noqa: F401
    Pipeline,
    PipelineModel,
)
from mmlspark_tpu_torch.io.serving import (  # noqa: F401
    ContinuousServingServer,
    ServingServer,
    serve_continuous,
    serve_pipeline,
)
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays  # noqa: F401
from mmlspark_tpu_torch.models.gbdt.estimators import (  # noqa: F401
    LightGBMClassificationModel,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRankerModel,
    LightGBMRegressionModel,
    LightGBMRegressor,
)
from mmlspark_tpu_torch.models.gbdt.trainer import (  # noqa: F401
    TrainConfig,
    train,
)
from mmlspark_tpu_torch.ops.binning import BinMapper  # noqa: F401

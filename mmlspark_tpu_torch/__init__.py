"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX one, grown slice by slice. It imports
``torch`` and numpy only: nothing of JAX and nothing of ``mmlspark_tpu``
(host code it needs is kept as its own copy). Layout mirrors the JAX
package so each counterpart is easy to find:

  - ``ops.binning``               BinMapper (numeric quantile binning)
  - ``models.gbdt.trainer``       TrainConfig / train (depthwise GBDT)
  - ``models.gbdt.booster``       BoosterArrays scoring
  - ``models.gbdt.hist_cuda``     the level-histogram kernel's wrapper
  - ``csrc/``                     hand-written CUDA kernels (sm_90a)
  - ``native.bindings``           builds ``csrc/*.cu`` with nvcc, loads them

Public entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays  # noqa: F401
from mmlspark_tpu_torch.models.gbdt.trainer import (  # noqa: F401
    TrainConfig,
    train,
)
from mmlspark_tpu_torch.ops.binning import BinMapper  # noqa: F401

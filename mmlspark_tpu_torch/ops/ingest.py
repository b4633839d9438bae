"""Ingest policies: the bin-id dtype (the port's copy of
``binned_ingest_dtype``) and the payload verification policy (its copy
of ``resolve_spill_verify``)."""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.env import SPILL_VERIFY, env_str
from mmlspark_tpu_torch.core.logging_utils import warn_once

_VERIFY_MODES = ("auto", "off", "on")


def binned_ingest_dtype(total_bins: int):
    """Narrowest integer dtype holding bin ids in [0, total_bins):
    uint8 for <= 256 bins, uint16 up to 65536, int32 beyond."""
    if total_bins <= 256:
        return np.uint8
    if total_bins <= 65536:
        return np.uint16
    return np.int32


def resolve_spill_verify() -> str:
    """``MMLSPARK_TORCH_SPILL_VERIFY`` policy: ``auto`` (the default) and
    ``on`` verify every checkpoint payload's crc32 at resume, ``off``
    trusts the disk. A bad value warns once and falls back to auto."""
    v = (env_str(SPILL_VERIFY, "auto") or "auto").strip().lower() or "auto"
    if v not in _VERIFY_MODES:
        warn_once("spill.verify.mode",
                  "%s=%r is not one of %s; using 'auto'", SPILL_VERIFY, v,
                  "|".join(_VERIFY_MODES))
        v = "auto"
    return v

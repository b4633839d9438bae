"""Bin-id dtype selection (the port's copy of ``binned_ingest_dtype``)."""

from __future__ import annotations

import numpy as np


def binned_ingest_dtype(total_bins: int):
    """Narrowest integer dtype holding bin ids in [0, total_bins):
    uint8 for <= 256 bins, uint16 up to 65536, int32 beyond."""
    if total_bins <= 256:
        return np.uint8
    if total_bins <= 65536:
        return np.uint16
    return np.int32

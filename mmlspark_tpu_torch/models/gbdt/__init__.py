"""Histogram GBDT on PyTorch: binning -> per-level histogram (CUDA
kernel on the card) -> depthwise tree growth -> binned scoring."""

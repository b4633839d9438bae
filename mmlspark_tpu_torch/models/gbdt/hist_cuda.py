"""Per-level GBDT histogram: the wrapper of the CUDA kernel
``csrc/level_hist.cu`` and its plain PyTorch version.

``level_histogram`` is the port of ``trainer._level_histogram`` (and of
the TPU kernel ``hist_pallas._hist_kernel`` behind it): (N, F) uint8 bin
ids plus per-row grad, hess, live and node-local id -> a (width, F, B, 3)
float32 histogram of (grad*live, hess*live, live) sums.

On a CUDA tensor it launches the kernel (a build or launch failure
raises); on a CPU tensor it runs ``level_histogram_reference``. There is
no other route. The kernel's design and bound are in the note at the top
of ``csrc/level_hist.cu``.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.native import bindings

# Launches of the level-histogram kernel in this process: the one
# module-level counter the port keeps, so a run can show that its main
# path went through the kernel.
hist_kernel_launches = 0

MAX_BINS = 256            # bin ids are uint8
TILE_ROWS = 4096          # rows per CTA: amortizes the per-CTA flush
SMEM_BYTES = 232_448      # dynamic shared memory a CTA may use on sm_90


def _check_inputs(binned, grad, hess, live, local, width, f, b):
    if binned.dtype != torch.uint8 or binned.dim() != 2:
        raise ValueError(f"binned must be a 2-d uint8 tensor, got "
                         f"{binned.dtype} with shape {tuple(binned.shape)}")
    n = binned.shape[0]
    if binned.shape[1] != f:
        raise ValueError(f"binned has {binned.shape[1]} features, expected {f}")
    if not 1 <= b <= MAX_BINS:
        raise ValueError(f"the level histogram supports 1..{MAX_BINS} bins, "
                         f"got {b}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    for name, t in (("grad", grad), ("hess", hess), ("live", live)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if local.dtype not in (torch.int32, torch.int64) \
            or tuple(local.shape) != (n,):
        raise ValueError(f"local must be int32/int64 of shape ({n},), got "
                         f"{local.dtype} {tuple(local.shape)}")
    for name, t in (("binned", binned), ("grad", grad), ("hess", hess),
                    ("live", live), ("local", local)):
        if t.device != binned.device:
            raise ValueError(f"{name} is on {t.device}, binned on "
                             f"{binned.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def level_histogram(binned, grad, hess, live, local, width: int, f: int,
                    b: int) -> torch.Tensor:
    """(width, F, B, 3) float32 sums of (grad*live, hess*live, live) by
    (local, feature, bin). ``local`` must lie in [0, width)."""
    _check_inputs(binned, grad, hess, live, local, width, f, b)
    if binned.device.type == "cpu":
        return level_histogram_reference(binned, grad, hess, live, local,
                                         width, f, b)
    return _launch(binned, grad, hess, live, local, width, f, b)


def level_histogram_reference(binned, grad, hess, live, local, width: int,
                              f: int, b: int) -> torch.Tensor:
    """Plain version: one ``index_add_`` over the flat index
    ``(local*F + f)*B + bin``."""
    n = binned.shape[0]
    feats = torch.arange(f, dtype=torch.int64, device=binned.device)
    idx = ((local.long()[:, None] * f + feats[None, :]) * b
           + binned.long()).reshape(-1)
    data = torch.stack([grad * live, hess * live, live], dim=-1)   # (n, 3)
    src = data[:, None, :].expand(n, f, 3).reshape(-1, 3)
    out = torch.zeros((width * f * b, 3), dtype=torch.float32,
                      device=binned.device)
    return out.index_add_(0, idx, src).reshape(width, f, b, 3)


def tile_plan(local: torch.Tensor, width: int, tile_rows: int = TILE_ROWS):
    """Rows sorted by node and cut into tiles, all on the device:
    ``(order, offsets, tile_end, num_tiles)``. ``order`` lists row ids by
    node (stable), node w owns ``order[offsets[w]:offsets[w+1]]``, and
    tiles ``[tile_end[w-1], tile_end[w])``. ``num_tiles`` is a static
    upper bound (every node adds at most one partial tile), so no host
    sync is needed; tiles past ``tile_end[-1]`` are empty."""
    n = local.shape[0]
    sorted_local, order = torch.sort(local, stable=True)
    nodes = torch.arange(width + 1, dtype=local.dtype, device=local.device)
    offsets = torch.searchsorted(sorted_local, nodes)
    counts = offsets[1:] - offsets[:-1]
    tile_end = torch.cumsum((counts + tile_rows - 1) // tile_rows, dim=0)
    return order, offsets, tile_end, n // tile_rows + width


def feature_slices(f: int, b: int, smem_bytes: int = SMEM_BYTES):
    """(features per CTA, number of slices): the fewest slices whose
    (slice, B, 3) float32 tile fits in one CTA's shared memory."""
    per_feature = b * 3 * 4
    most = max(1, smem_bytes // per_feature)
    num_slices = -(-f // most)
    return -(-f // num_slices), num_slices


def _launch(binned, grad, hess, live, local, width, f, b):
    global hist_kernel_launches
    lib = bindings.load("level_hist")
    out = torch.zeros((width, f, b, 3), dtype=torch.float32,
                      device=binned.device)
    n = binned.shape[0]
    if n == 0:
        return out
    order, offsets, tile_end, num_tiles = tile_plan(local, width)
    f_slice, num_slices = feature_slices(f, b)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    code = lib.mmls_level_hist(
        binned.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        live.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        tile_end.data_ptr(), out.data_ptr(), f, b, width, TILE_ROWS,
        num_tiles, f_slice, num_slices, binned.device.index, stream)
    bindings.check(lib, code, "level_hist kernel launch")
    hist_kernel_launches += 1
    return out

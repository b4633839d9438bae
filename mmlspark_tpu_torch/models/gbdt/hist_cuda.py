"""Per-level GBDT histogram: the wrappers of the CUDA kernels
``csrc/level_hist.cu`` (float32 stats) and ``csrc/level_hist_quant.cu``
(int16/int8 quantized stats), and their plain PyTorch versions.

``level_histogram`` is the port of ``trainer._level_histogram`` (and of
the TPU kernel ``hist_pallas._hist_kernel`` behind it): (N, F) uint8 bin
ids plus per-row grad, hess, live and node-local id -> a (width, F, B, 3)
float32 histogram of (grad*live, hess*live, live) sums. The sums are
taken in fixed point (``fixed_point_exponents``): each term is scaled by
a per-channel power of two, rounded to an int64 and summed exactly, and
each sum is rounded to float32 once. The result is the same bits in any
row order and on any device, so the float32 fit is reproducible run to
run on the card, as the reference's is.

``level_histogram_quant`` is the port of
``trainer._level_histogram_quant`` (``hist_pallas.
pallas_level_histogram_quant`` on the TPU): int16/int8 grad and hess
summed exactly in integers over the rows with ``live > 0``, then
dequantized once, ``float32(int64_sum * float64(scale_inv))`` — the
native merge of the JAX package's C++ data plane. Integer sums commute,
so the result is the same bits whatever order rows are added in.

On a CUDA tensor each wrapper launches its kernel (a build or launch
failure raises); on a CPU tensor it runs its plain version. There is no
other route. The kernels' designs and bounds are in the notes at the
top of their sources.
"""

from __future__ import annotations

import torch

from mmlspark_tpu_torch.native import bindings

# Launches of each histogram kernel in this process, so a run can show
# that its main path went through the kernels.
hist_kernel_launches = 0
hist_quant_kernel_launches = 0

MAX_BINS = 256            # bin ids are uint8
CHUNK_ROWS = 256          # level_hist.cu: rows a CTA stages at once
WARP_LANES = 32           # a lane per feature of a row
PLAN_SEG_ROWS = 512       # rows per warp of the partition
MAX_WIDTH = 12287         # the partition's per-warp key counters (48 KB)
SMEM_BYTES = 232_448      # dynamic shared memory a CTA may use on sm_90
QUANT_CHUNK_ROWS = 1024   # level_hist_quant.cu: rows a CTA stages at once
QUANT_STAGES = 2          # level_hist_quant.cu: chunks in its staging ring
QUANT_DTYPES = (torch.int16, torch.int8)


def _check_inputs(binned, grad, hess, live, local, width, f, b,
                  stat_dtypes=(torch.float32,)):
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
    if grad.dtype not in stat_dtypes or hess.dtype != grad.dtype:
        raise ValueError(f"grad and hess must share one dtype of "
                         f"{stat_dtypes}, got {grad.dtype} and {hess.dtype}")
    for name, t in (("grad", grad), ("hess", hess), ("live", live)):
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
    if live.dtype != torch.float32:
        raise ValueError(f"live must be float32, got {live.dtype}")
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


def flat_index(binned, local, f: int, b: int) -> torch.Tensor:
    """(N*F,) int64 histogram cell of every (row, feature):
    ``(local*F + f)*B + bin``."""
    feats = torch.arange(f, dtype=torch.int64, device=binned.device)
    return ((local.long()[:, None] * f + feats[None, :]) * b
            + binned.long()).reshape(-1)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 (0 for 0), by halving shifts."""
    length = torch.zeros_like(v)
    for s in (32, 16, 8, 4, 2, 1):
        big = (v >> s) > 0
        v = torch.where(big, v >> s, v)
        length += big * s
    return length + (v > 0)


def fixed_point_exponents(amax: torch.Tensor, n: int) -> torch.Tensor:
    """Per channel, the largest integer ``e`` with ``n * amax * 2^e <=
    2^62`` (0 where ``amax`` is 0), as int64, computed exactly: with
    ``amax = m * 2^(ea - 24)`` (``m`` frexp's mantissa times 2^24, an
    integer) and ``L`` the bit length of ``n * m``, ``e = 86 - ea - L``,
    plus 1 where ``n * m`` is a power of two. ``n`` terms of magnitude at
    most ``amax * 2^e``, each rounded to an integer, then sum to under
    2^62 + n/2 < 2^63. ``csrc/level_hist.cu`` computes the same on the
    card."""
    man, ea = torch.frexp(amax.float())
    nm = n * (man * 2.0 ** 24).long()
    e = 86 - ea.long() - _bit_length(nm) + ((nm & (nm - 1)) == 0).long()
    return torch.where(amax > 0, e, torch.zeros_like(e))


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float64, exactly, built from its bits (|e| <= 1022)."""
    return ((e.long() + 1023) << 52).view(torch.float64)


def level_histogram_reference(binned, grad, hess, live, local, width: int,
                              f: int, b: int) -> torch.Tensor:
    """Plain version: the fixed-point sums with one int64 ``index_add_``
    over ``flat_index``. Per channel c of ``(grad*live, hess*live,
    live)``: ``e_c = fixed_point_exponents(max|x_c|, N)``, terms
    ``round_half_even(float64(x) * 2^e_c)`` as int64 (the product is
    exact), exact sums, and ``float32(float64(sum) * 2^-e_c)``."""
    n = binned.shape[0]
    data = torch.stack([grad * live, hess * live, live], dim=-1)   # (n, 3)
    e = fixed_point_exponents(data.abs().amax(dim=0) if n else
                              torch.zeros(3, device=binned.device), n)
    terms = torch.round(data.double() * pow2(e)).long()
    src = terms[:, None, :].expand(n, f, 3).reshape(-1, 3)
    acc = torch.zeros((width * f * b, 3), dtype=torch.int64,
                      device=binned.device).index_add_(
        0, flat_index(binned, local, f, b), src)
    return (acc.double() * pow2(-e)).float().reshape(width, f, b, 3)


def _lane_slices(f: int, fits):
    """(features per CTA, number of slices) for a kernel that adds a
    row's features with one warp, a lane per feature: the fewest slices of
    at most 32 features for which ``fits(f_slice)`` holds, as even as
    possible, and multiples of 4 where F is (a row's bin bytes are then
    whole words)."""
    most = WARP_LANES
    while most > 4 and not fits(most):
        most -= 4
    num_slices = -(-f // most)
    f_slice = -(-f // num_slices)
    if f % 4 == 0:
        f_slice = -(-f_slice // 4) * 4
    return f_slice, -(-f // f_slice)


def f32_feature_slices(f: int, b: int):
    """(features per CTA, number of slices) of ``csrc/level_hist.cu``:
    its cells (over 32 lanes) and staged chunks fit one CTA's shared
    memory (:func:`f32_smem_bytes`; 28 features at B = 256)."""
    return _lane_slices(f, lambda fs: f32_smem_bytes(fs, b) <= SMEM_BYTES)


def f32_smem_bytes(f_slice: int, b: int) -> int:
    """Dynamic shared memory of one ``level_hist.cu`` CTA: int64 cells
    as two 32-bit planes per channel over (B, 32 lanes); two stages of
    ``CHUNK_ROWS`` rows' stats (16 bytes), bin bytes (padded to a word)
    and row ids (8 bytes); the chunk's int64 terms (32 bytes a row)."""
    return (6 * b * WARP_LANES * 4
            + CHUNK_ROWS * (2 * 16 + 32 + 2 * (-(-f_slice // 4) * 4) + 2 * 8))


def _check_card_limits(width, n):
    """Both kernels partition the rows on the card with per-warp key
    counters (at most ``MAX_WIDTH`` + 1 keys) and int32 row places."""
    if width > MAX_WIDTH or n >= 2 ** 31:
        raise ValueError(f"the level-histogram kernels take width <= "
                         f"{MAX_WIDTH} and n < 2^31, got width {width}, "
                         f"n {n}")


def _partition_scratch(n, width, dev):
    """The partition's scratch (``csrc/level_hist_common.cuh``): its
    counts (per warp segment, then per CTA: at most one CTA per segment),
    the nodes' offsets and the kept rows in node order."""
    return (torch.empty(2 * (width + 1) * -(-n // PLAN_SEG_ROWS),
                        dtype=torch.int32, device=dev),
            torch.empty(width + 1, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev))


def _launch(binned, grad, hess, live, local, width, f, b):
    global hist_kernel_launches
    n = binned.shape[0]
    _check_card_limits(width, n)
    lib = bindings.load("level_hist")
    dev = binned.device
    if n == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32, device=dev)
    out = torch.empty((width, f, b, 3), dtype=torch.float32, device=dev)
    # the int64 sums, then 6 int64 of scratch: the amax bits and e_c
    acc = torch.zeros(width * f * b * 3 + 6, dtype=torch.int64, device=dev)
    # per row (grad*live, hess*live, live, 0)
    stats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    counts, offsets, order = _partition_scratch(n, width, dev)
    f_slice, num_slices = f32_feature_slices(f, b)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mmls_level_hist(
        binned.data_ptr(), grad.data_ptr(), hess.data_ptr(), live.data_ptr(),
        local.data_ptr(), local.element_size(), stats.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        acc.data_ptr(), out.data_ptr(), n, f, b, width, f_slice, num_slices,
        f32_smem_bytes(f_slice, b), dev.index, stream)
    bindings.check(lib, code, "level_hist kernel launch")
    hist_kernel_launches += 1
    return out


# --- quantized stats ---------------------------------------------------------

def quant_window(bits: int) -> int:
    """The rows W of one node that a ``level_hist_quant.cu`` CTA's int32
    cells take between flushes: each row adds at most 2^(bits-1) to a
    cell, and W * 2^(bits-1) <= 2^31 - 1 (q16: 65,535; q8: 16,777,215).
    The CTA flushes once one more chunk could pass it."""
    return (2 ** 31 - 1) // 2 ** (bits - 1)


def quant_feature_slices(f: int, b: int):
    """(features per CTA, number of slices) of ``csrc/level_hist_quant.cu``
    (:func:`quant_smem_bytes`): at B <= 256 every slice of 32 features
    fits."""
    return _lane_slices(f, lambda fs: quant_smem_bytes(fs, b) <= SMEM_BYTES)


def quant_smem_bytes(f_slice: int, b: int) -> int:
    """Dynamic shared memory of one ``level_hist_quant.cu`` CTA: int32
    cells in three channel planes over (B, 32 lanes); ``QUANT_STAGES``
    chunks of ``QUANT_CHUNK_ROWS`` rows' packed stat words (4 bytes), row
    ids (4 bytes) and bin bytes (padded to a word)."""
    return (3 * b * WARP_LANES * 4
            + QUANT_STAGES * QUANT_CHUNK_ROWS * (4 + 4 + -(-f_slice // 4) * 4))


def level_histogram_quant(binned, grad_q, hess_q, live, local, width: int,
                          f: int, b: int, gscale_inv,
                          hscale_inv) -> torch.Tensor:
    """(width, F, B, 3) float32 sums of (grad_q, hess_q, 1) over the rows
    with ``live > 0``, by (local, feature, bin), dequantized once by the
    inverse scales (0-d float32 tensors on the device of ``binned``, or
    floats). ``grad_q`` / ``hess_q`` are int16 or int8."""
    _check_inputs(binned, grad_q, hess_q, live, local, width, f, b,
                  stat_dtypes=QUANT_DTYPES)
    gsi, hsi = (torch.as_tensor(s, dtype=torch.float32, device=binned.device)
                for s in (gscale_inv, hscale_inv))
    if gsi.dim() or hsi.dim():
        raise ValueError("gscale_inv and hscale_inv must be scalars")
    if binned.device.type == "cpu":
        return level_histogram_quant_reference(
            binned, grad_q, hess_q, live, local, width, f, b, gsi, hsi)
    return _launch_quant(binned, grad_q, hess_q, live, local, width, f, b,
                         gsi, hsi)


def level_histogram_quant_reference(binned, grad_q, hess_q, live, local,
                                    width: int, f: int, b: int, gscale_inv,
                                    hscale_inv) -> torch.Tensor:
    """Plain version: one int64 ``index_add_`` over ``flat_index``, then
    ``float32(int64_sum * float64(scale_inv))``, one rounding (scale 1
    for the count channel)."""
    n = binned.shape[0]
    gate = (live > 0).long()
    data = torch.stack([grad_q.long() * gate, hess_q.long() * gate, gate],
                       dim=-1)                                   # (n, 3)
    src = data[:, None, :].expand(n, f, 3).reshape(-1, 3)
    acc = torch.zeros((width * f * b, 3), dtype=torch.int64,
                      device=binned.device).index_add_(
        0, flat_index(binned, local, f, b), src)
    one = torch.ones((), dtype=torch.float64, device=binned.device)
    scales = torch.stack([one * gscale_inv, one * hscale_inv, one])
    return (acc.double() * scales).float().reshape(width, f, b, 3)


def _launch_quant(binned, grad_q, hess_q, live, local, width, f, b, gsi,
                  hsi):
    global hist_quant_kernel_launches
    n = binned.shape[0]
    _check_card_limits(width, n)
    lib = bindings.load("level_hist_quant")
    dev = binned.device
    if n == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32, device=dev)
    out = torch.empty((width, f, b, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((width, f, b, 3), dtype=torch.int64, device=dev)
    # per row the packed (grad_q, hess_q) word
    stats = torch.empty(n, dtype=torch.int32, device=dev)
    counts, offsets, order = _partition_scratch(n, width, dev)
    f_slice, num_slices = quant_feature_slices(f, b)
    bits = grad_q.element_size() * 8
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mmls_level_hist_quant(
        binned.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(),
        live.data_ptr(), local.data_ptr(), local.element_size(),
        stats.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
        order.data_ptr(), acc.data_ptr(), out.data_ptr(), gsi.data_ptr(),
        hsi.data_ptr(), bits, n, f, b, width, f_slice, num_slices,
        quant_smem_bytes(f_slice, b), quant_window(bits), dev.index, stream)
    bindings.check(lib, code, "level_hist_quant kernel launch")
    hist_quant_kernel_launches += 1
    return out

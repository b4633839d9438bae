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
TILE_ROWS = 4096          # rows per CTA: amortizes the per-CTA flush
SMEM_BYTES = 232_448      # dynamic shared memory a CTA may use on sm_90
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


def tile_plan(local: torch.Tensor, width: int, keep: torch.Tensor,
              tile_rows: int = TILE_ROWS):
    """Rows sorted by node and cut into tiles, all on the device:
    ``(order, offsets, tile_end, num_tiles)``. ``order`` lists row ids by
    node (stable), node w owns ``order[offsets[w]:offsets[w+1]]``, and
    tiles ``[tile_end[w-1], tile_end[w])``. Rows where ``keep`` is false
    sort to a key past the last node, so they fall in no tile and no
    kernel reads them; the stable order of the kept rows is unchanged.
    ``num_tiles`` is a static upper bound (every node adds at most one
    partial tile), so no host sync is needed; tiles past
    ``tile_end[-1]`` are empty."""
    n = local.shape[0]
    key = torch.where(keep, local, width)
    sorted_local, order = torch.sort(key, stable=True)
    nodes = torch.arange(width + 1, dtype=local.dtype, device=local.device)
    offsets = torch.searchsorted(sorted_local, nodes)
    counts = offsets[1:] - offsets[:-1]
    tile_end = torch.cumsum((counts + tile_rows - 1) // tile_rows, dim=0)
    return order, offsets, tile_end, n // tile_rows + width


def feature_slices(f: int, b: int, smem_bytes: int = SMEM_BYTES,
                   cell_bytes: int = 4):
    """(features per CTA, number of slices): the fewest slices whose
    (slice, B, 3) tile of ``cell_bytes`` cells (int64 for the float32
    stats in fixed point, int32 for the quantized stats) fits in one CTA's
    shared memory."""
    per_feature = b * 3 * cell_bytes
    most = max(1, smem_bytes // per_feature)
    num_slices = -(-f // most)
    return -(-f // num_slices), num_slices


def _launch(binned, grad, hess, live, local, width, f, b):
    global hist_kernel_launches
    lib = bindings.load("level_hist")
    n = binned.shape[0]
    if n == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32,
                           device=binned.device)
    out = torch.empty((width, f, b, 3), dtype=torch.float32,
                      device=binned.device)
    # the int64 sums, then 6 int64 of scratch: the amax bits and e_c
    acc = torch.zeros(width * f * b * 3 + 6, dtype=torch.int64,
                      device=binned.device)
    order, offsets, tile_end, num_tiles = tile_plan(local, width, live != 0)
    f_slice, num_slices = feature_slices(f, b, cell_bytes=8)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    code = lib.mmls_level_hist(
        binned.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        live.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        tile_end.data_ptr(), acc.data_ptr(), out.data_ptr(), n, f, b, width,
        TILE_ROWS, num_tiles, f_slice, num_slices, binned.device.index,
        stream)
    bindings.check(lib, code, "level_hist kernel launch")
    hist_kernel_launches += 1
    return out


# --- quantized stats ---------------------------------------------------------

def check_tile_fits(tile_rows: int, dtype: torch.dtype) -> None:
    """A CTA's int32 cell grows by at most the largest magnitude of
    ``dtype`` per row of its tile; raise unless a whole tile stays below
    2^31 (q16: 4096 * 32768 = 2^27). This plays the part of the native
    kernel's periodic flush into int64."""
    qmax = -torch.iinfo(dtype).min
    if tile_rows * qmax >= 2 ** 31:
        raise ValueError(f"tile_rows={tile_rows} x |{dtype}| max {qmax} "
                         "could overflow a CTA's int32 histogram cell")


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
    check_tile_fits(TILE_ROWS, grad_q.dtype)
    lib = bindings.load("level_hist_quant")
    if binned.shape[0] == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32,
                           device=binned.device)
    out = torch.empty((width, f, b, 3), dtype=torch.float32,
                      device=binned.device)
    acc = torch.zeros((width, f, b, 3), dtype=torch.int64,
                      device=binned.device)
    order, offsets, tile_end, num_tiles = tile_plan(local, width, live > 0)
    f_slice, num_slices = feature_slices(f, b)
    stream = torch.cuda.current_stream(binned.device).cuda_stream
    code = lib.mmls_level_hist_quant(
        binned.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(),
        order.data_ptr(), offsets.data_ptr(), tile_end.data_ptr(),
        acc.data_ptr(), out.data_ptr(), gsi.data_ptr(), hsi.data_ptr(),
        grad_q.element_size() * 8, f, b, width, TILE_ROWS, num_tiles,
        f_slice, num_slices, binned.device.index, stream)
    bindings.check(lib, code, "level_hist_quant kernel launch")
    hist_quant_kernel_launches += 1
    return out

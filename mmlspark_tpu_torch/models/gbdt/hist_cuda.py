"""Per-level GBDT histogram: the wrappers of the CUDA kernels
``csrc/level_hist.cu`` (float32 stats) and ``csrc/level_hist_quant.cu``
(int16/int8 quantized stats), and their plain PyTorch versions.

``level_histogram`` is the port of ``trainer._level_histogram`` (and of
the TPU kernel ``hist_pallas._hist_kernel`` behind it): (N, F) uint8 bin
ids (B <= 256), uint16 ids (B <= 65,536: the reference's ids past 256
bins, ``binned_ingest_dtype``) or int32 ids (past 65,536 bins), plus
per-row grad, hess, live and node-local id -> a (width, F, B, 3) float32
histogram of (grad*live, hess*live, live) sums. The sums are taken in
fixed point (``fixed_point_exponents``): each term is scaled by a
per-channel power of two, rounded to an int64 and summed exactly, and
each sum is rounded to float32 once. The result is the same bits in any
row order and on any device, so the float32 fit is reproducible run to
run on the card, as the reference's is.

``level_histogram_quant_sums`` and ``dequantize_sums`` split the
quantized histogram in two for out-of-core training (``ooc.py``): each
chunk of rows adds its integer sums into a running (width, F, B, 3)
int64 accumulator on the device, and the merged sums are dequantized
once, with the same expression, so the merged histogram is the one
pass's bit for bit (the JAX package merges chunks on the host,
``models/gbdt/ooc.py:210-244``).

``level_histogram_quant`` is the port of
``trainer._level_histogram_quant`` (``hist_pallas.
pallas_level_histogram_quant`` on the TPU): int16/int8 grad and hess
summed exactly in integers over the rows with ``live > 0``, then
dequantized once, ``float32(int64_sum * float64(scale_inv))`` — the
native merge of the JAX package's C++ data plane. Integer sums commute,
so the result is the same bits whatever order rows are added in.

On a CUDA tensor each wrapper launches its kernel (a build or launch
failure raises): the instance of the ids' dtype (uint8, uint16, int32;
nothing narrows or clamps ids onto another instance). On a CPU tensor
it runs its plain version. There is no other route. Either way the
histogram passes the ``gbdt.level_hist`` fault point
(``core/faults.py``), where the reference's native histogram entries
have it; disarmed, that is one flag check. The kernels' designs and
bounds are in the notes at the top of their sources.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.native import bindings

# Launches of each histogram kernel in this process, so a run can show
# that its main path went through the kernels. A launch recorded into a
# CUDA graph is not one: it counts into the capture's tally
# (``captured_launches``), and every replay of the graph adds the tally
# here (``count_replay``).
hist_kernel_launches = 0
hist_quant_kernel_launches = 0
# the kernels' uint16-id and int32-id instances, counted apart
hist_u16_kernel_launches = 0
hist_quant_u16_kernel_launches = 0
hist_i32_kernel_launches = 0
hist_quant_i32_kernel_launches = 0
# the quantized kernel's chunk-merge entry (``level_histogram_quant_sums``:
# no dequantization) on uint8, uint16 and int32 ids, and the
# dequantization of merged sums (``dequantize_sums``), counted apart from
# the above
hist_quant_sums_kernel_launches = 0
hist_quant_sums_u16_kernel_launches = 0
hist_quant_sums_i32_kernel_launches = 0
hist_quant_dequant_launches = 0
# the float32 kernel's entries for rows split over ranks
# (``level_histogram_amax``, ``level_histogram_sums`` on uint8, uint16 and
# int32 ids, ``fixed_point_round``), counted apart from the one-pass entry
hist_amax_launches = 0
hist_sums_kernel_launches = 0
hist_sums_u16_kernel_launches = 0
hist_sums_i32_kernel_launches = 0
hist_round_launches = 0
_capture = threading.local()


def _count_launch(counter: str) -> None:
    """One launch of the kernel ``counter`` counts: into this thread's
    capture tally while its stream is capturing, else into the module
    counter."""
    tally = getattr(_capture, "tally", None)
    if tally is not None and torch.cuda.is_current_stream_capturing():
        tally[counter] = tally.get(counter, 0) + 1
    else:
        globals()[counter] += 1


@contextlib.contextmanager
def captured_launches():
    """Collect the launches this thread records into a graph inside the
    block: yields the tally, {counter name: launches per replay}."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = prev


def count_replay(tally: Dict[str, int]) -> None:
    """A replay of a graph whose capture tallied ``tally`` ran: its
    launches count."""
    for counter, launches in tally.items():
        globals()[counter] += launches

# the bin-id dtypes the kernels take, and the most bins of each (int32
# ids: every non-negative id)
BIN_DTYPES = {torch.uint8: 256, torch.uint16: 65_536, torch.int32: 2 ** 31}
# the launch counters' suffix of each id width (bytes)
_INSTANCE = {1: "_kernel_launches", 2: "_u16_kernel_launches",
             4: "_i32_kernel_launches"}
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
    if binned.dtype not in BIN_DTYPES or binned.dim() != 2:
        raise ValueError(f"binned must be a 2-d uint8, uint16 or int32 "
                         f"tensor, got {binned.dtype} with shape "
                         f"{tuple(binned.shape)}")
    n = binned.shape[0]
    if binned.shape[1] != f:
        raise ValueError(f"binned has {binned.shape[1]} features, expected {f}")
    most = BIN_DTYPES[binned.dtype]
    if not 1 <= b <= most:
        raise ValueError(f"the level histogram supports 1..{most} bins on "
                         f"{binned.dtype} ids, got {b}")
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
        out = level_histogram_reference(binned, grad, hess, live, local,
                                        width, f, b)
    else:
        out = _launch(binned, grad, hess, live, local, width, f, b)
    return fault_point("gbdt.level_hist", out)


def bin_ids(binned) -> torch.Tensor:
    """The bin ids of a uint8, uint16 or int32 tensor as int64. uint16
    goes through its int16 view (``& 0xFFFF``): torch implements few ops
    on uint16 tensors."""
    if binned.dtype == torch.uint16:
        return binned.view(torch.int16).long() & 0xFFFF
    return binned.long()


def flat_index(binned, local, f: int, b: int) -> torch.Tensor:
    """(N*F,) int64 histogram cell of every (row, feature):
    ``(local*F + f)*B + bin``."""
    feats = torch.arange(f, dtype=torch.int64, device=binned.device)
    return ((local.long()[:, None] * f + feats[None, :]) * b
            + bin_ids(binned)).reshape(-1)


def _cell_sums(binned, local, data, width: int, f: int,
               b: int) -> torch.Tensor:
    """(width*F*B, 3) int64: the sums of the (N, 3) int64 rows ``data``
    over every (row, feature)'s cell of :func:`flat_index`, a channel at
    a time. Integer sums are the same in any order, so on the CPU slices
    of the features, whose cells are their own, are summed on a thread
    each (``torch.get_num_threads()`` slices)."""
    n, dev = binned.shape[0], binned.device
    acc = torch.zeros((3, width * f * b), dtype=torch.int64, device=dev)
    base = local.long()[:, None] * f

    def add(span):
        lo, hi = span
        cells = ((base + torch.arange(lo, hi, device=dev)) * b
                 + bin_ids(binned[:, lo:hi])).reshape(-1)
        for c in range(3):
            acc[c].index_add_(0, cells, data[:, c, None].expand(
                n, hi - lo).reshape(-1))

    parts = torch.get_num_threads() if dev.type == "cpu" else 1
    step = max(1, -(-f // parts))
    spans = [(lo, min(lo + step, f)) for lo in range(0, f, step)]
    if len(spans) > 1:
        with ThreadPoolExecutor(len(spans)) as pool:
            list(pool.map(add, spans))
    else:
        for span in spans:
            add(span)
    return acc.t()


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
    """Plain version: the fixed-point sums with int64 ``index_add_``
    over ``flat_index``'s cells (:func:`_cell_sums`). Per channel c of
    ``(grad*live, hess*live, live)``: ``e_c = fixed_point_exponents(
    max|x_c|, N)``, terms ``round_half_even(float64(x) * 2^e_c)`` as
    int64 (the product is exact), exact sums, and
    ``float32(float64(sum) * 2^-e_c)``. Contiguous, as the kernel's
    histogram is: the split scans' float reductions over it then add in
    the same order as over the kernel's, and as over the sums reduced
    from several ranks (:func:`fixed_point_round`)."""
    n = binned.shape[0]
    data = torch.stack([grad * live, hess * live, live], dim=-1)   # (n, 3)
    e = fixed_point_exponents(data.abs().amax(dim=0) if n else
                              torch.zeros(3, device=binned.device), n)
    terms = torch.round(data.double() * pow2(e)).long()
    acc = _cell_sums(binned, local, terms, width, f, b).contiguous()
    return (acc.double() * pow2(-e)).float().reshape(width, f, b, 3)


def _lane_slices(f: int, fits):
    """(features per CTA, number of slices) for a kernel on uint8 ids that
    adds a row's features with one warp, a lane per feature: the fewest
    slices of at most 32 features for which ``fits(f_slice)`` holds, as
    even as possible, and multiples of 4 where F is (a row's bin bytes are
    then whole words)."""
    most = WARP_LANES
    while most > 4 and not fits(most):
        most -= 4
    num_slices = -(-f // most)
    f_slice = -(-f // num_slices)
    if f % 4 == 0:
        f_slice = -(-f_slice // 4) * 4
    return f_slice, -(-f // f_slice)


def u16_words(f: int, f_slice: int) -> int:
    """The 4-byte words a uint16 row's slice of ``f_slice`` ids spans once
    staged (``level_hist_common.cuh``: the words covering ids [r*F + f0,
    ... + fs) from the tensor's start): ceil(f_slice / 2), and one more
    where f_slice is even and F odd (rows then start at either half of a
    word)."""
    return (f_slice + 1) // 2 + (1 if f_slice % 2 == 0 and f % 2 else 0)


def u16_cell(fs: int, fl: int, bin_: int) -> int:
    """The word of cell (feature fl, bin) in a plane of a uint16 CTA's
    cells over a slice of ``fs`` features (``level_hist_common.cuh``:
    ``U16Cells``): rows of 32 words, feature fl owning the g = 32 // fs
    banks [g * fl, g * fl + g), bin at (bin // g) * 32 + g * fl + bin % g.
    A warp adds g rows at once, so each feature's lanes fall on its own g
    banks."""
    g = WARP_LANES // fs
    return bin_ // g * WARP_LANES + g * fl + bin_ % g


def u16_plane_words(f_slice: int, tile_bins: int) -> int:
    """The words of one plane of a uint16 CTA's cells (:func:`u16_cell`):
    32 for each group of 32 // f_slice bins of the tile."""
    g = WARP_LANES // f_slice
    return -(-tile_bins // g) * WARP_LANES


def _u16_plan(f: int, b: int, smem_bytes):
    """(features per CTA, slices, bins per tile, tiles) of a kernel's
    uint16 instance, whose CTA needs ``smem_bytes(f, f_slice, tile_bins)``
    of shared memory: the widest slice (at most 32 features) whose cells
    of every bin fit, then the fewest slices of it, as even as possible,
    and one tile. Only where one feature's bins do not fit does a slice
    hold one feature and the bins go in the fewest tiles that fit, as even
    as possible."""
    def fits(fs, bins):
        return smem_bytes(f, fs, bins) <= SMEM_BYTES

    most = min(f, WARP_LANES)
    while most > 1 and not fits(most, b):
        most -= 1
    if fits(most, b):
        num_slices = -(-f // most)
        return -(-f // num_slices), num_slices, b, 1
    cap, above = 1, b                  # the most bins one feature's cells fit
    while above - cap > 1:
        mid = (cap + above) // 2
        cap, above = (mid, above) if fits(1, mid) else (cap, mid)
    num_tiles = -(-b // cap)
    return 1, f, -(-b // num_tiles), num_tiles


def f32_plan(f: int, b: int, bin_bytes: int = 1):
    """(features per CTA, slices, bins per tile, tiles) of
    ``csrc/level_hist.cu``: on uint8 ids the slices of
    :func:`f32_feature_slices` and one tile of B bins; on uint16 ids
    :func:`_u16_plan` over :func:`f32_u16_smem_bytes` (at F = 28: 2
    slices of 14 at B = 511, 4 of 7 at 1,023, 14 of 2 at 4,095; tiles of
    bins past about 8,700)."""
    if bin_bytes == 1:
        return (*f32_feature_slices(f, b), b, 1)
    return _u16_plan(f, b, f32_u16_smem_bytes)


def f32_feature_slices(f: int, b: int):
    """(features per CTA, number of slices) of ``csrc/level_hist.cu``
    on uint8 ids: its cells (over 32 lanes) and staged chunks fit one
    CTA's shared memory (:func:`f32_smem_bytes`; 28 features at B =
    256)."""
    return _lane_slices(f, lambda fs: f32_smem_bytes(fs, b) <= SMEM_BYTES)


def f32_smem_bytes(f_slice: int, b: int) -> int:
    """Dynamic shared memory of one ``level_hist.cu`` CTA on uint8 ids:
    int64 cells as two 32-bit planes per channel over (B, 32 lanes); two
    stages of ``CHUNK_ROWS`` rows' stats (16 bytes), bin bytes (padded to
    a word) and row ids (8 bytes); the chunk's int64 terms (32 bytes a
    row)."""
    return (6 * b * WARP_LANES * 4
            + CHUNK_ROWS * (2 * 16 + 32 + 2 * (-(-f_slice // 4) * 4) + 2 * 8))


def f32_u16_smem_bytes(f: int, f_slice: int, tile_bins: int) -> int:
    """Dynamic shared memory of one ``level_hist.cu`` CTA on uint16 ids:
    int64 cells as two 32-bit planes (:func:`u16_plane_words`) per
    channel over the slice's features and the tile's bins; the staging of
    :func:`f32_smem_bytes` with each row's ids as :func:`u16_words`
    words."""
    return (6 * u16_plane_words(f_slice, tile_bins) * 4
            + CHUNK_ROWS * (2 * 16 + 32 + 2 * 4 * u16_words(f, f_slice)
                            + 2 * 8))


# int32 ids (``level_hist_common.cuh``: ``hist_i32_kernel``): a cell's
# three int64 sums as six 32-bit words of shared memory, and a CTA's
# static shared memory (the warps' staging words, the item index), with
# room to spare
I32_CELL_BYTES = 24
I32_STATIC_SMEM = 4160
I32_THREADS = 1024        # threads of a CTA (kI32Threads)
I32_WORDS = 8             # key words (4 places each) a lane loads at once


def i32_plan(f: int, b: int):
    """(features per CTA, slices, bins per tile, tiles) of both kernels'
    int32 instance (both planes keep int64 cells, so they share it; the
    uint8 / uint16 plans are :func:`f32_plan` and :func:`quant_plan`):
    an item is one (node, feature, tile), so a slice is
    one feature; the bins go in the fewest tiles whose int64 cells
    (:func:`i32_smem_bytes`) fit one CTA's shared memory, as even as
    possible (14 tiles of 9,363 bins at B = 131,072; 8 of 8,750 at
    70,000)."""
    cap = (SMEM_BYTES - I32_STATIC_SMEM) // I32_CELL_BYTES
    num_tiles = -(-b // cap)
    return 1, f, -(-b // num_tiles), num_tiles


def i32_smem_bytes(tile_bins: int) -> int:
    """Dynamic shared memory of one int32-instance CTA: the tile's int64
    cells, three channels as low and high 32-bit planes."""
    return I32_CELL_BYTES * tile_bins


def i32_key_stride(n: int) -> int:
    """The stride of the int32 instance's tile-key columns: N rounded up
    to 16 bytes, so every column starts on a word."""
    return -(-n // 16) * 16


def i32_scratch_bytes(n: int, f: int, stat_bytes: int) -> int:
    """Bytes of an int32-instance launch's scratch (``level_hist_common.
    cuh``: ``I32Scratch``): the items' counter (16 bytes), each kept row's
    stats in node order (``stat_bytes``: a float4 on the float32 plane, a
    packed word on the quantized one), its ids as (F, N) int32 columns in
    that order, and each id's tile key as (F, :func:`i32_key_stride`)
    bytes."""
    return 16 + n * stat_bytes + f * n * 4 + f * i32_key_stride(n)


def launch_grid(sms: int, per_sm: int, num_slices: int, num_tiles: int,
                bin_bytes: int):
    """(CTAs launched, CTAs per tile of bins) of a histogram launch on
    ``sms`` SMs that hold ``per_sm`` CTAs each (``level_hist_common.cuh``:
    ``hist_grid``). uint8 ids, one tile: a CTA per SM slot, at least one
    per slice. uint16 ids: at most one wave; each tile takes max(slices,
    floor(wave / tiles)) CTAs, and where those pass a wave the launched
    CTAs take them in turn. int32 ids: at most one wave, whose CTAs take
    the (node, feature, tile) items in turn (at least slices x tiles of
    them, at width 1): a CTA per slice (feature) of a tile and node."""
    wave = sms * per_sm
    if bin_bytes == 4:
        return min(num_slices * num_tiles, wave), num_slices
    if bin_bytes != 2:
        ctas = max(wave, num_slices)
        return ctas, ctas
    per_tile = max(num_slices, wave // num_tiles)
    return min(per_tile * num_tiles, wave), per_tile


def _kernel_plan(plane: str, f: int, b: int, bin_bytes: int):
    """(features per CTA, slices, bins per tile, tiles, shared memory
    bytes of a CTA) of a histogram launch on ``plane`` ("f32" or
    "quant"). On int32 ids both planes take ``level_hist_common.cuh``'s
    tiles of bins (:func:`i32_plan`)."""
    if bin_bytes == 4:
        plan = i32_plan(f, b)
        return (*plan, i32_smem_bytes(plan[2]))
    if plane == "f32":
        f_slice, num_slices, tile_bins, num_tiles = f32_plan(f, b, bin_bytes)
        smem = (f32_smem_bytes(f_slice, b) if bin_bytes == 1
                else f32_u16_smem_bytes(f, f_slice, tile_bins))
    else:
        f_slice, num_slices, tile_bins, num_tiles = quant_plan(f, b,
                                                               bin_bytes)
        smem = (quant_smem_bytes(f_slice, b) if bin_bytes == 1
                else quant_u16_smem_bytes(f, f_slice, tile_bins))
    return f_slice, num_slices, tile_bins, num_tiles, smem


def launch_geometry(plane: str, f: int, b: int,
                    bin_bytes: int) -> Dict[str, int]:
    """The grid a histogram launch takes on the current card (``plane``
    "f32" or "quant"): the plan's features per slice, slices, bins per
    tile and tiles, the shared memory of a CTA, and from the kernel's
    library the SMs, CTAs per SM (the occupancy API), CTAs launched and
    CTAs per tile."""
    plan = _kernel_plan(plane, f, b, bin_bytes)
    name = "level_hist" if plane == "f32" else "level_hist_quant"
    lib = bindings.load(name)
    out = (ctypes.c_int * 4)()
    code = getattr(lib, f"mmls_{name}_grid")(bin_bytes, plan[4], plan[1],
                                             plan[3],
                                             torch.cuda.current_device(), out)
    bindings.check(lib, code, f"{name} grid")
    return dict(zip(("f_slice", "slices", "tile_bins", "tiles",
                     "smem_bytes", "sms", "per_sm", "ctas", "per_tile"),
                    (*plan, *out)))


def _word_aligned(binned):
    """The ids as the kernels take them: a uint16 view that starts off a
    4-byte boundary is copied (a kernel stages a row as the 4-byte words
    covering its ids); int32 ids always start on one."""
    if binned.element_size() == 2 and binned.data_ptr() % 4:
        return binned.clone()
    return binned


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


def _i32_scratch(binned, stat_bytes):
    """The int32 instance's scratch (:func:`i32_scratch_bytes`; on a
    16-byte boundary, as every allocation of the card's caching
    allocator is), or None for narrower ids."""
    if binned.element_size() != 4:
        return None
    n, f = binned.shape
    return torch.empty(i32_scratch_bytes(n, f, stat_bytes),
                       dtype=torch.uint8, device=binned.device)


def _launch(binned, grad, hess, live, local, width, f, b):
    n = binned.shape[0]
    _check_card_limits(width, n)
    lib = bindings.load("level_hist")
    dev = binned.device
    if n == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32, device=dev)
    out = torch.empty((width, f, b, 3), dtype=torch.float32, device=dev)
    bin_bytes = binned.element_size()
    # the int64 sums (none on int32 ids: their tiles' sums stay in shared
    # memory), then 6 int64 of scratch: the amax bits and e_c
    cells = 0 if bin_bytes == 4 else width * f * b * 3
    acc = torch.zeros(cells + 6, dtype=torch.int64, device=dev)
    # per row (grad*live, hess*live, live, 0)
    stats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    counts, offsets, order = _partition_scratch(n, width, dev)
    wide = _i32_scratch(binned, 16)
    f_slice, num_slices, tile_bins, num_tiles, smem = _kernel_plan(
        "f32", f, b, bin_bytes)
    binned = _word_aligned(binned)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mmls_level_hist(
        binned.data_ptr(), grad.data_ptr(), hess.data_ptr(), live.data_ptr(),
        local.data_ptr(), local.element_size(), stats.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        None if wide is None else wide.data_ptr(),
        acc.data_ptr(), out.data_ptr(), n, f, b, width, f_slice, num_slices,
        bin_bytes, tile_bins, num_tiles, smem, dev.index, stream)
    bindings.check(lib, code, "level_hist kernel launch")
    _count_launch("hist" + _INSTANCE[bin_bytes])
    return out


# --- rows split over ranks ---------------------------------------------------
#
# ``level_histogram`` takes its exponents from its own rows. A rank of a
# multi-device fit (``parallel_modes.py``) holds a share of the rows, so
# the function is split in three: each rank's channel maxima
# (``level_histogram_amax``), reduced over the ranks (max) and turned into
# exponents with the global row count (``fixed_point_exponents(amax, N)``);
# each rank's int64 sums under those exponents (``level_histogram_sums``),
# reduced over the ranks (an integer sum, the same in any order); and one
# rounding (``fixed_point_round``). The result is ``level_histogram`` on
# the whole rows, bit for bit. N is the rows of the serial fit: padding
# rows (``live`` 0) add nothing to the maxima or the sums, but an exponent
# taken from a padded count would sit on another grid.

def level_histogram_amax(grad, hess, live) -> torch.Tensor:
    """(3,) float32: the largest magnitude of each channel of (grad*live,
    hess*live, live) over the rows (0 where there are none). On a CUDA
    tensor one launch of ``mmls_level_hist_amax``; on a CPU tensor its
    plain version."""
    n = live.shape[0]
    for name, t in (("grad", grad), ("hess", hess), ("live", live)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) \
                or not t.is_contiguous() or t.device != live.device:
            raise ValueError(f"{name} must be a contiguous float32 ({n},) "
                             f"tensor on {live.device}")
    if live.device.type == "cpu":
        return level_histogram_amax_reference(grad, hess, live)
    global hist_amax_launches
    lib = bindings.load("level_hist")
    bits = torch.zeros(3, dtype=torch.int64, device=live.device)
    if n:
        code = lib.mmls_level_hist_amax(
            grad.data_ptr(), hess.data_ptr(), live.data_ptr(),
            bits.data_ptr(), n, live.device.index,
            torch.cuda.current_stream(live.device).cuda_stream)
        bindings.check(lib, code, "level_hist amax launch")
        hist_amax_launches += 1
    return bits.to(torch.int32).view(torch.float32)


def level_histogram_amax_reference(grad, hess, live) -> torch.Tensor:
    """Plain version: ``max |x_c|`` over the rows of (grad*live,
    hess*live, live), as ``level_histogram_reference`` takes it."""
    if not live.shape[0]:
        return torch.zeros(3, dtype=torch.float32, device=live.device)
    return torch.stack([grad * live, hess * live, live],
                       dim=-1).abs().amax(dim=0)


def _check_sums(acc, exps, width, f, b, dev):
    if (acc.dtype != torch.int64 or tuple(acc.shape) != (width, f, b, 3)
            or acc.device != dev or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous int64 ({width}, {f}, "
                         f"{b}, 3) tensor on {dev}, got {acc.dtype} "
                         f"{tuple(acc.shape)} on {acc.device}")
    if exps.dtype != torch.int64 or tuple(exps.shape) != (3,) \
            or exps.device != dev or not exps.is_contiguous():
        raise ValueError(f"exps must be a contiguous int64 (3,) tensor on "
                         f"{dev}, got {exps.dtype} {tuple(exps.shape)} on "
                         f"{exps.device}")


def level_histogram_sums(binned, grad, hess, live, local, width: int,
                         f: int, b: int, exps: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """Add the fixed-point int64 sums of (grad*live, hess*live, live) by
    (local, feature, bin) under the exponents ``exps`` ((3,) int64 on the
    device of ``binned``: ``fixed_point_exponents`` of the maxima over
    every rank's rows and their count) into ``acc``, a contiguous
    (width, F, B, 3) int64 tensor there, and return it: no rounding. On a
    CUDA tensor one call of ``mmls_level_hist_sums`` (partition and
    histogram), on a CPU tensor its plain version."""
    _check_inputs(binned, grad, hess, live, local, width, f, b)
    _check_sums(acc, exps, width, f, b, binned.device)
    if binned.device.type == "cpu":
        acc += level_histogram_sums_reference(binned, grad, hess, live,
                                              local, width, f, b, exps)
        return acc
    n = binned.shape[0]
    if n == 0:
        return acc
    _check_card_limits(width, n)
    lib = bindings.load("level_hist")
    dev = binned.device
    stats = torch.empty((n, 4), dtype=torch.float32, device=dev)
    counts, offsets, order = _partition_scratch(n, width, dev)
    wide = _i32_scratch(binned, 16)
    bin_bytes = binned.element_size()
    f_slice, num_slices, tile_bins, num_tiles, smem = _kernel_plan(
        "f32", f, b, bin_bytes)
    binned = _word_aligned(binned)
    code = lib.mmls_level_hist_sums(
        binned.data_ptr(), grad.data_ptr(), hess.data_ptr(), live.data_ptr(),
        local.data_ptr(), local.element_size(), stats.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), order.data_ptr(),
        None if wide is None else wide.data_ptr(), exps.data_ptr(),
        acc.data_ptr(), n, f, b, width, f_slice, num_slices, bin_bytes,
        tile_bins, num_tiles, smem, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    bindings.check(lib, code, "level_hist sums launch")
    _count_launch("hist_sums" + _INSTANCE[bin_bytes])
    return acc


def level_histogram_sums_reference(binned, grad, hess, live, local,
                                   width: int, f: int, b: int,
                                   exps) -> torch.Tensor:
    """Plain version: the (width, F, B, 3) int64 sums of the terms
    ``round_half_even(float64(x_c) * 2^e_c)``, int64 ``index_add_`` over
    ``flat_index``'s cells (:func:`_cell_sums`), contiguous."""
    data = torch.stack([grad * live, hess * live, live], dim=-1)   # (n, 3)
    terms = torch.round(data.double() * pow2(exps)).long()
    return _cell_sums(binned, local, terms, width, f, b).contiguous().reshape(
        width, f, b, 3)


def fixed_point_round(acc: torch.Tensor, exps: torch.Tensor) -> torch.Tensor:
    """The float32 histogram of int64 sums ``acc`` ((width, F, B, 3),
    contiguous) under ``exps``: ``float32(float64(sum) * 2^-e_c)``, the
    rounding of :func:`level_histogram`. On a CUDA tensor one launch of
    ``mmls_level_hist_round``, on a CPU tensor its plain version. The
    histogram passes the ``gbdt.level_hist`` fault point, as the other
    wrappers' do."""
    if acc.dtype != torch.int64 or acc.dim() != 4 or acc.shape[3] != 3 \
            or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous int64 (width, F, B, 3) "
                         f"tensor, got {acc.dtype} {tuple(acc.shape)}")
    _check_sums(acc, exps, *acc.shape[:3], acc.device)
    if acc.device.type == "cpu":
        out = fixed_point_round_reference(acc, exps)
    else:
        global hist_round_launches
        lib = bindings.load("level_hist")
        out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
        code = lib.mmls_level_hist_round(
            acc.data_ptr(), exps.data_ptr(), out.data_ptr(), acc.numel(),
            acc.device.index, torch.cuda.current_stream(acc.device).cuda_stream)
        bindings.check(lib, code, "level_hist round launch")
        hist_round_launches += 1
    return fault_point("gbdt.level_hist", out)


def fixed_point_round_reference(acc, exps) -> torch.Tensor:
    """Plain version of the rounding: ``float32(float64(acc) *
    2^-e_c)``."""
    return (acc.double() * pow2(-exps)).float()


# --- quantized stats ---------------------------------------------------------

def quant_window(bits: int) -> int:
    """The rows W of one node that a ``level_hist_quant.cu`` CTA's int32
    cells take between flushes: each row adds at most 2^(bits-1) to a
    cell, and W * 2^(bits-1) <= 2^31 - 1 (q16: 65,535; q8: 16,777,215).
    The CTA flushes once one more chunk could pass it."""
    return (2 ** 31 - 1) // 2 ** (bits - 1)


def quant_plan(f: int, b: int, bin_bytes: int = 1):
    """(features per CTA, slices, bins per tile, tiles) of
    ``csrc/level_hist_quant.cu``: on uint8 ids the slices of
    :func:`quant_feature_slices` and one tile of B bins; on uint16 ids
    :func:`_u16_plan` over :func:`quant_u16_smem_bytes` (at F = 28: 2
    slices of 14 at B = 511, 3 of 10 at 1,023, 7 of 4 at 4,095; tiles of
    bins past about 17,000)."""
    if bin_bytes == 1:
        return (*quant_feature_slices(f, b), b, 1)
    return _u16_plan(f, b, quant_u16_smem_bytes)


def quant_feature_slices(f: int, b: int):
    """(features per CTA, number of slices) of ``csrc/level_hist_quant.cu``
    on uint8 ids (:func:`quant_smem_bytes`): at B <= 256 every slice of
    32 features fits."""
    return _lane_slices(f, lambda fs: quant_smem_bytes(fs, b) <= SMEM_BYTES)


def quant_smem_bytes(f_slice: int, b: int) -> int:
    """Dynamic shared memory of one ``level_hist_quant.cu`` CTA on uint8
    ids: int32 cells in three channel planes over (B, 32 lanes);
    ``QUANT_STAGES`` chunks of ``QUANT_CHUNK_ROWS`` rows' packed stat
    words (4 bytes), row ids (4 bytes) and bin bytes (padded to a word)."""
    return (3 * b * WARP_LANES * 4
            + QUANT_STAGES * QUANT_CHUNK_ROWS * (4 + 4 + -(-f_slice // 4) * 4))


def quant_u16_smem_bytes(f: int, f_slice: int, tile_bins: int) -> int:
    """Dynamic shared memory of one ``level_hist_quant.cu`` CTA on uint16
    ids: int32 cells in three channel planes (:func:`u16_plane_words`)
    over the slice's features and the tile's bins; the staging ring of
    :func:`quant_smem_bytes` with each row's ids as :func:`u16_words`
    words and a byte of the row's parity."""
    return (3 * u16_plane_words(f_slice, tile_bins) * 4
            + QUANT_STAGES * QUANT_CHUNK_ROWS
            * (4 + 4 + 4 * u16_words(f, f_slice) + 1))


def level_histogram_quant(binned, grad_q, hess_q, live, local, width: int,
                          f: int, b: int, gscale_inv,
                          hscale_inv) -> torch.Tensor:
    """(width, F, B, 3) float32 sums of (grad_q, hess_q, 1) over the rows
    with ``live > 0``, by (local, feature, bin), dequantized once by the
    inverse scales (0-d float32 tensors on the device of ``binned``, or
    floats). ``grad_q`` / ``hess_q`` are int16 or int8."""
    _check_inputs(binned, grad_q, hess_q, live, local, width, f, b,
                  stat_dtypes=QUANT_DTYPES)
    gsi, hsi = _scales(gscale_inv, hscale_inv, binned.device)
    if binned.device.type == "cpu":
        out = level_histogram_quant_reference(
            binned, grad_q, hess_q, live, local, width, f, b, gsi, hsi)
    else:
        out = _launch_quant(binned, grad_q, hess_q, live, local, width, f, b,
                            gsi, hsi)
    return fault_point("gbdt.level_hist", out)


def level_histogram_quant_reference(binned, grad_q, hess_q, live, local,
                                    width: int, f: int, b: int, gscale_inv,
                                    hscale_inv) -> torch.Tensor:
    """Plain version: int64 ``index_add_`` over ``flat_index``'s cells
    (:func:`level_histogram_quant_sums_reference`), then
    ``float32(int64_sum * float64(scale_inv))``, one rounding (scale 1
    for the count channel; :func:`dequantize_reference`)."""
    return dequantize_reference(level_histogram_quant_sums_reference(
        binned, grad_q, hess_q, live, local, width, f, b), gscale_inv,
        hscale_inv)


def _scales(gscale_inv, hscale_inv, dev):
    gsi, hsi = (torch.as_tensor(s, dtype=torch.float32, device=dev)
                for s in (gscale_inv, hscale_inv))
    if gsi.dim() or hsi.dim():
        raise ValueError("gscale_inv and hscale_inv must be scalars")
    return gsi, hsi


def level_histogram_quant_sums(binned, grad_q, hess_q, live, local,
                               width: int, f: int, b: int,
                               acc: torch.Tensor) -> torch.Tensor:
    """Add the integer sums of (grad_q, hess_q, 1) over the rows with
    ``live > 0``, by (local, feature, bin), into ``acc``, a contiguous
    (width, F, B, 3) int64 tensor on the device of ``binned`` that the
    caller keeps across calls (zeros before the first chunk), and return
    it. No dequantization: :func:`dequantize_sums` takes the merged sums.
    On a CUDA tensor it launches ``csrc/level_hist_quant.cu``'s partition
    and histogram (a build or launch failure raises), on a CPU tensor it
    adds :func:`_cell_sums`, the plain version."""
    _check_inputs(binned, grad_q, hess_q, live, local, width, f, b,
                  stat_dtypes=QUANT_DTYPES)
    if (acc.dtype != torch.int64 or tuple(acc.shape) != (width, f, b, 3)
            or acc.device != binned.device or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous int64 ({width}, {f}, "
                         f"{b}, 3) tensor on {binned.device}, got "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")
    if binned.device.type == "cpu":
        acc += level_histogram_quant_sums_reference(
            binned, grad_q, hess_q, live, local, width, f, b)
    elif binned.shape[0]:
        _launch_quant(binned, grad_q, hess_q, live, local, width, f, b,
                      None, None, acc=acc)
    return acc


def level_histogram_quant_sums_reference(binned, grad_q, hess_q, live,
                                         local, width: int, f: int,
                                         b: int) -> torch.Tensor:
    """Plain version: the (width, F, B, 3) int64 sums of one chunk,
    int64 ``index_add_`` over ``flat_index``'s cells
    (:func:`_cell_sums`), contiguous as the kernel's sums are (so the
    histograms of both, and the reductions over them, are laid out
    alike)."""
    gate = (live > 0).long()
    data = torch.stack([grad_q.long() * gate, hess_q.long() * gate, gate],
                       dim=-1)                                   # (n, 3)
    return _cell_sums(binned, local, data, width, f, b).contiguous().reshape(
        width, f, b, 3)


def dequantize_sums(acc: torch.Tensor, gscale_inv,
                    hscale_inv) -> torch.Tensor:
    """The (width, F, B, 3) float32 histogram of merged int64 sums,
    ``float32(int64_sum * float64(scale_inv))`` (scale 1 for the count
    channel): the dequantization of :func:`level_histogram_quant`, bit
    for bit. On a CUDA tensor one launch of the kernel's own
    dequantization (``mmls_level_hist_quant_dequantize``), on a CPU
    tensor :func:`dequantize_reference`. The histogram passes the
    ``gbdt.level_hist`` fault point, as the other wrappers' do."""
    if acc.dtype != torch.int64 or acc.dim() != 4 or acc.shape[3] != 3 \
            or not acc.is_contiguous():
        raise ValueError(f"acc must be a contiguous int64 (width, F, B, 3) "
                         f"tensor, got {acc.dtype} {tuple(acc.shape)}")
    gsi, hsi = _scales(gscale_inv, hscale_inv, acc.device)
    if acc.device.type == "cpu":
        out = dequantize_reference(acc, gsi, hsi)
    else:
        global hist_quant_dequant_launches
        lib = bindings.load("level_hist_quant")
        out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
        code = lib.mmls_level_hist_quant_dequantize(
            acc.data_ptr(), out.data_ptr(), gsi.data_ptr(), hsi.data_ptr(),
            acc.numel(), acc.device.index,
            torch.cuda.current_stream(acc.device).cuda_stream)
        bindings.check(lib, code, "level_hist_quant dequantize launch")
        hist_quant_dequant_launches += 1
    return fault_point("gbdt.level_hist", out)


def dequantize_reference(acc, gscale_inv, hscale_inv) -> torch.Tensor:
    """Plain version of the dequantization:
    ``float32(float64(acc) * float64(scale_inv))`` per channel."""
    one = torch.ones((), dtype=torch.float64, device=acc.device)
    scales = torch.stack([one * gscale_inv, one * hscale_inv, one])
    return (acc.double() * scales).float()


def _launch_quant(binned, grad_q, hess_q, live, local, width, f, b, gsi,
                  hsi, acc=None):
    """The kernel's launches: into a fresh accumulator, dequantized into
    the returned histogram; or, given ``acc``, added into it with no
    dequantization (the chunk-merge entry: ``out`` null)."""
    n = binned.shape[0]
    _check_card_limits(width, n)
    lib = bindings.load("level_hist_quant")
    dev = binned.device
    merge = acc is not None
    if n == 0:
        return torch.zeros((width, f, b, 3), dtype=torch.float32, device=dev)
    bin_bytes = binned.element_size()
    if merge:
        out, dequant = None, (None, None, None)
    else:
        out = torch.empty((width, f, b, 3), dtype=torch.float32, device=dev)
        # int32 ids write the histogram from their tiles' sums in shared
        # memory: no int64 sums
        if bin_bytes != 4:
            acc = torch.zeros((width, f, b, 3), dtype=torch.int64,
                              device=dev)
        dequant = (out.data_ptr(), gsi.data_ptr(), hsi.data_ptr())
    # per row the packed (grad_q, hess_q) word
    stats = torch.empty(n, dtype=torch.int32, device=dev)
    counts, offsets, order = _partition_scratch(n, width, dev)
    wide = _i32_scratch(binned, 4)
    f_slice, num_slices, tile_bins, num_tiles, smem = _kernel_plan(
        "quant", f, b, bin_bytes)
    binned = _word_aligned(binned)
    bits = grad_q.element_size() * 8
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mmls_level_hist_quant(
        binned.data_ptr(), grad_q.data_ptr(), hess_q.data_ptr(),
        live.data_ptr(), local.data_ptr(), local.element_size(),
        stats.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
        order.data_ptr(), None if wide is None else wide.data_ptr(),
        None if acc is None else acc.data_ptr(), *dequant, bits, n, f, b,
        width, f_slice, num_slices, bin_bytes, tile_bins, num_tiles, smem,
        quant_window(bits), dev.index, stream)
    bindings.check(lib, code, "level_hist_quant kernel launch")
    _count_launch(("hist_quant_sums" if merge else "hist_quant")
                  + _INSTANCE[bin_bytes])
    return out

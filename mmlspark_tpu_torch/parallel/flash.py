"""Fused softmax attention: the wrappers of the CUDA kernels
``csrc/flash_attn_sm90.cu`` and ``csrc/flash_attn.cu``, and their plain
PyTorch version.

Port of ``mmlspark_tpu.parallel.flash`` (the TPU kernel ``_flash_kernel``):
q (batch, seq, heads, head_dim), k and v (batch, kv_seq, heads, head_dim)
-> ``softmax(q kᵀ / √d, masked) v`` of q's shape and type. Both versions
run the TPU kernel's recurrence in float32: q scaled before the product,
an online softmax over KV blocks, masked scores of -1e30, and
``acc / max(l, 1e-30)`` at the end. Causal masking is top-left aligned
(query i sees key j when i >= j, both from 0).

On a CUDA tensor ``flash_attention`` launches a kernel (a build, encode
or launch failure raises); on a CPU tensor it runs the plain version.
:func:`flash_route` picks the route from the inputs' type, head dim,
base addresses and strides alone: every bfloat16 call runs on
``flash_attn_sm90.cu`` (wgmma, TMA, a producer warp), in place where TMA
can read the inputs, else on a staged copy (:func:`stage_for_tma`, counted
in ``flash_staged_calls``); float32 calls run on ``flash_attn.cu`` (CUDA
cores, float32). There is no other route, no fallback and no opt-in: both
kernels are held against the plain version on the card by
``chip_smoke.py``. The kernels have no gradient, as the TPU kernel has
none; the wrapper raises on inputs that require one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.native import bindings

# Launches in this process, so a run can show that its path went through
# the kernels: of either kernel, and of csrc/flash_attn_sm90.cu alone; and
# the calls of flash_attn_sm90.cu on staged copies.
flash_kernel_launches = 0
flash_sm90_launches = 0
flash_staged_calls = 0

NEG_INF = -1e30
MAX_HEAD_DIM = 128        # the kernels' largest head_dim
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # -> flash_attn.cu's code

# the routes of flash_route
SIMT, SM90, SM90_STAGED = ("flash_attn", "flash_attn_sm90",
                           "flash_attn_sm90+staged")
# flash_attn_sm90.cu: the rows of its q and key tiles, which are the TMA
# boxes' rows; the bf16 columns of a box (128 bytes: the swizzle span); the
# elements whose multiple TMA needs of a stride (16 bytes); and TMA's limit
# on a stride in bytes
SM90_TILE_ROWS = 128
TMA_BOX_COLS = 64
TMA_ALIGN_ELEMS = 8
TMA_MAX_STRIDE_BYTES = 1 << 40


def flash_available(device: DeviceLike = None) -> bool:
    """True when ``device`` (``None``: the card) is a CUDA device that is
    present, where ``flash_attention`` launches the kernel."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cuda" and torch.cuda.is_available()


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (batch, seq, heads, head_dim)")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be ({b}, kv_seq, {h}, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention reads float32 or bfloat16 q, k "
                         f"and v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is outside the kernel's limit "
                         f"1..{MAX_HEAD_DIM}")


def flash_attention(q, k, v, block_q: int = 128, block_k: int = 128,
                    causal: bool = False,
                    device: DeviceLike = None) -> torch.Tensor:
    """Fused attention: q/k/v (batch, seq, heads, head_dim) -> q's shape
    and type. Sequence lengths must divide the blocks (after
    ``block = min(block, length)``), as on the TPU. Numpy arrays or
    tensors; ``device=None`` is the card."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=dev) for x in (q, k, v))
    _check_inputs(q, k, v)
    n, nk = q.shape[1], k.shape[1]
    block_q = min(block_q, n)
    block_k = min(block_k, nk)
    if n % block_q or nk % block_k:
        raise ValueError(f"seq lengths ({n}, {nk}) must be divisible by "
                         f"blocks ({block_q}, {block_k})")
    if dev.type == "cpu":
        return flash_attention_reference(q, k, v, block_k=block_k,
                                         causal=causal)
    return _launch(q, k, v, causal)


def flash_attention_reference(q, k, v, block_k: int = 128,
                              causal: bool = False) -> torch.Tensor:
    """Plain version: ``_flash_kernel``'s recurrence over ``block_k`` KV
    blocks in float32, all query rows at once (rows are independent)."""
    b, n, h, d = q.shape
    nk = k.shape[1]
    block_k = min(block_k, nk)
    scale = 1.0 / (d ** 0.5)
    qs = q.float().transpose(1, 2) * scale                    # (b, h, n, d)
    kt, vt = k.float().transpose(1, 2), v.float().transpose(1, 2)
    acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(n, device=q.device)[:, None]
    for start in range(0, nk, block_k):
        kb = kt[:, :, start:start + block_k]
        vb = vt[:, :, start:start + block_k]
        s = qs @ kb.transpose(-1, -2)                         # (b, h, n, bk)
        if causal:
            k_pos = start + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, NEG_INF)
        new_m = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - new_m[..., None])
        corr = torch.exp(m - new_m)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = new_m
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def check_kernel_inputs(q, k, v) -> None:
    """What the kernel path refuses beyond ``flash_attention``'s checks:
    inputs that require a gradient (the kernel has none). Grids past the
    launch limits are refused by the launch itself."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash kernel has no gradient; pass inputs "
                           "that do not require grad (torch.no_grad() or "
                           ".detach()), or use blockwise_attention")


def flash_route(dtype, head_dim: int, data_ptrs, strides) -> str:
    """How a CUDA call runs, from the inputs' type, head dim, base
    addresses and (b, n, h, d) element strides alone: ``"flash_attn"``
    (``flash_attn.cu``) for float32; for bfloat16 ``"flash_attn_sm90"``
    where TMA reads the inputs in place — head_dim a multiple of 8, every
    base 16-byte aligned, every (b, n, h) stride a positive multiple of 8
    elements under 2^40 bytes, d contiguous — and
    ``"flash_attn_sm90+staged"`` (the same kernel on copies made by
    :func:`stage_for_tma`) otherwise."""
    if dtype != torch.bfloat16:
        return SIMT
    if head_dim % TMA_ALIGN_ELEMS or any(p % 16 for p in data_ptrs):
        return SM90_STAGED
    for st in strides:
        if st[3] != 1 or any(s <= 0 or s % TMA_ALIGN_ELEMS
                             or 2 * s >= TMA_MAX_STRIDE_BYTES
                             for s in st[:3]):
            return SM90_STAGED
    return SM90


def stage_for_tma(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous (b, n, h, d8) copy of ``t``, d8 = d rounded up to
    a multiple of 8 and the columns past d zero: a layout that TMA reads in
    place (a new allocation is aligned far beyond 16 bytes)."""
    b, n, h, d = t.shape
    d8 = -(-d // TMA_ALIGN_ELEMS) * TMA_ALIGN_ELEMS
    if d8 == d:
        return t.clone(memory_format=torch.contiguous_format)
    staged = torch.zeros((b, n, h, d8), dtype=t.dtype, device=t.device)
    staged[..., :d].copy_(t)
    return staged


def tma_geometry(shape, strides, itemsize: int, rows: int) -> dict:
    """The 4-D tensor map through which ``flash_attn_sm90.cu`` reads a
    (b, n, h, d) tensor in place: dims (d, h, n, b), innermost first; the
    byte strides of h, n and b; the box (64 columns, 1 head, ``rows``
    rows, 1 batch), whose columns past d TMA fills with zeros; and the
    swizzle span in bytes (the box's row)."""
    b, n, h, d = shape
    return {"dims": (d, h, n, b),
            "strides": tuple(strides[i] * itemsize for i in (2, 1, 0)),
            "box": (TMA_BOX_COLS, 1, rows, 1),
            "swizzle": TMA_BOX_COLS * itemsize}


@functools.lru_cache(maxsize=1024)
def _sm90_geometry(dtype, q_shape, q_stride, k_shape, k_stride, v_stride):
    """:func:`flash_route`'s rules other than the base addresses' and, when
    they hold, the 36 integers the C side reads (per tensor q, k, v:
    :func:`tma_geometry`'s dims, strides, box and swizzle) as a C array,
    else None. Cached by shapes and strides, so a call that repeats a
    layout pays for neither."""
    strides = (q_stride, k_stride, v_stride)
    if flash_route(dtype, q_shape[3], (0, 0, 0), strides) != SM90:
        return None
    vals = []
    for shape, st in zip((q_shape, k_shape, k_shape), strides):
        g = tma_geometry(tuple(shape), st, dtype.itemsize, SM90_TILE_ROWS)
        vals += [*g["dims"], *g["strides"], *g["box"], g["swizzle"]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global flash_staged_calls
    check_kernel_inputs(q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype != torch.bfloat16:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        _launch_simt(q, k, v, out, causal)
        return out
    # flash_route, with the address-free part cached by layout
    geom = _sm90_geometry(q.dtype, q.shape, q.stride(), k.shape, k.stride(),
                          v.stride())
    staged = geom is None or bool((q.data_ptr() | k.data_ptr()
                                   | v.data_ptr()) % 16)
    if staged:
        q, k, v = (stage_for_tma(t) for t in (q, k, v))
        geom = _sm90_geometry(q.dtype, q.shape, q.stride(), k.shape,
                              k.stride(), v.stride())
    _launch_sm90(q, k, v, out, causal, geom, d)
    if staged:
        flash_staged_calls += 1
    return out


def _launch_simt(q, k, v, out, causal: bool) -> None:
    """``csrc/flash_attn.cu``: float32 arithmetic on the CUDA cores (its
    bfloat16 build is reached by no route)."""
    global flash_kernel_launches
    b, n, h, d = q.shape
    lib = bindings.load("flash_attn")
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    code = lib.mmls_flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], b, h, n, k.shape[1], d, *strides,
        ctypes.c_float(1.0 / (d ** 0.5)), int(causal), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    bindings.check(lib, code, "flash_attn kernel launch")
    flash_kernel_launches += 1


def _launch_sm90(q, k, v, out, causal: bool, geom, d: int) -> None:
    """``csrc/flash_attn_sm90.cu``: bfloat16 on the tensor cores; the C
    side encodes the tensor maps from ``geom`` (:func:`_sm90_geometry`).
    ``d`` is the head dim (q's last dim is d8 on a staged copy)."""
    global flash_kernel_launches, flash_sm90_launches
    b, n, h, _ = q.shape
    lib = bindings.load("flash_attn_sm90")
    code = lib.mmls_flash_attn_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        geom, b, h, n, k.shape[1], d,
        *out.stride()[:3], ctypes.c_float(1.0 / (d ** 0.5)), int(causal),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    bindings.check(lib, code, "flash_attn_sm90 kernel launch")
    flash_kernel_launches += 1
    flash_sm90_launches += 1

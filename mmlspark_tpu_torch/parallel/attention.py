"""Long-context attention: dense, blockwise, fused, ring and Ulysses.

Port of ``mmlspark_tpu.parallel.attention``. Shapes follow (batch, seq,
heads, head_dim); causal masks use global positions, so sharded and
dense results agree.

- :func:`blockwise_attention`: online softmax over KV blocks (a Python
  loop where the JAX package has ``lax.scan``), O(block) memory.
- :func:`fused_attention`: the flash kernel (``parallel.flash``) when
  both lengths divide by 128, else blockwise — the JAX package's routing
  by shape. On the card that is the CUDA kernel ``csrc/flash_attn.cu``.
- :func:`ring_attention`: each rank of the sequence-parallel group holds
  one contiguous sequence shard; KV shards rotate around the ring
  (``batch_isend_irecv`` to rank r+1, from rank r-1) while each rank
  accumulates its queries' online softmax.
- :func:`ulysses_attention`: ``all_to_all_single`` swaps the sequence
  shard for a head shard, :func:`fused_attention` runs per head group,
  and a second ``all_to_all_single`` swaps back.

Where the JAX functions take global arrays and a mesh, the distributed
ones here take each rank's own shard (b, n/P, h, d) and return its output
shard; the group comes from ``parallel.mesh.sequence_group``. Products
outside the flash kernel are plain ``torch.einsum``, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from mmlspark_tpu_torch.core import sanitizer
from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.parallel import flash as _flash
from mmlspark_tpu_torch.parallel.mesh import SEQUENCE_AXIS, sequence_group

NEG_INF = -1e30


def _tensors(device: DeviceLike, *arrays):
    dev = resolve_device(device)
    return dev, [torch.as_tensor(a, device=dev) for a in arrays]


def _block_attend(q, k, v, out, row_max, row_sum, q_offset: int,
                  k_offset: int, causal: bool, scale: float):
    """One online-softmax accumulation step. q: (b, nq, h, d); k/v:
    (b, nk, h, d); out/row_max/row_sum are the running accumulators.
    Returns the updated (out, row_max, row_sum)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                             NEG_INF)
    new_max = torch.maximum(row_max, scores.amax(dim=-1))     # (b, h, q)
    correction = torch.exp(row_max - new_max)
    p = torch.exp(scores - new_max[..., None])
    new_sum = row_sum * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    new_out = out * correction.transpose(1, 2)[..., None] + pv
    return new_out, new_max, new_sum


def _fit_block(nk: int, block_size: int) -> int:
    """The largest divisor of ``nk`` that fits ``block_size`` (a 704-long
    sequence streams in 352-wide blocks); lengths whose divisors are all
    tiny (primes) take one dense tile instead of a column-at-a-time
    loop."""
    block = min(block_size, nk)
    while nk % block:
        block -= 1
    if block < min(block_size, nk) // 4:
        block = nk
    return block


def _streamed_attend(q, k, v, out, row_max, row_sum, q_offset: int,
                     k_offset: int, causal: bool, scale: float,
                     block_size: int = 512):
    """Online-softmax accumulation over ``k``/``v`` in sub-blocks, so the
    score tile is (nq, block) instead of (nq, nk)."""
    nk = k.shape[1]
    block = _fit_block(nk, block_size)
    for start in range(0, nk, block):
        out, row_max, row_sum = _block_attend(
            q, k[:, start:start + block], v[:, start:start + block], out,
            row_max, row_sum, q_offset, k_offset + start, causal, scale)
    return out, row_max, row_sum


def _init_stats(q):
    b, n, h, _ = q.shape
    return (torch.zeros_like(q),
            torch.full((b, h, n), NEG_INF, dtype=q.dtype, device=q.device),
            torch.zeros((b, h, n), dtype=q.dtype, device=q.device))


def _normalize(out, row_sum):
    return out / torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]


def blockwise_attention(q, k, v, block_size: int = 512,
                        causal: bool = False,
                        device: DeviceLike = None) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV blocks, with
    accumulators in q's type."""
    _, (q, k, v) = _tensors(device, q, k, v)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    out, row_max, row_sum = _streamed_attend(
        q, k, v, *_init_stats(q), 0, 0, causal, scale, block_size)
    return _normalize(out, row_sum)


def fused_attention(q, k, v, causal: bool = False, block_size: int = 512,
                    device: DeviceLike = None) -> torch.Tensor:
    """Single-device attention through the flash kernel when both
    sequence lengths divide by 128, else the blockwise loop."""
    dev, (q, k, v) = _tensors(device, q, k, v)
    if q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0:
        return _flash.flash_attention(q, k, v, causal=causal, device=dev)
    return blockwise_attention(q, k, v, block_size=block_size,
                               causal=causal, device=dev)


def _sequence_length(chunk: int, group, size: int, dev) -> int:
    """The global sequence length; every rank must hold an equal shard.
    One small all_gather, so every rank raises alike."""
    mine = torch.tensor([chunk], dtype=torch.int64, device=dev)
    lengths = [torch.empty_like(mine) for _ in range(size)]
    dist.all_gather(lengths, mine, group=group)
    lengths = [int(t.item()) for t in lengths]
    n = sum(lengths)
    if n % size:
        raise ValueError(f"sequence {n} not divisible by sp={size}")
    if len(set(lengths)) != 1:
        raise ValueError(f"sequence shards must be of equal length, got "
                         f"{lengths}")
    return n


def _rotate(tensors, group, rank: int, size: int):
    """Send each tensor to rank r+1 of the group, receive from r-1 (one
    ``ppermute`` event per tensor for the sanitizer, as the reference
    records its ring)."""
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        sanitizer.record_collective("ppermute", SEQUENCE_AXIS, t.shape,
                                    t.dtype)
        ops += [dist.P2POp(dist.isend, t, nxt, group),
                dist.P2POp(dist.irecv, r, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def ring_attention(q, k, v, group: Optional[dist.ProcessGroup] = None,
                   causal: bool = False,
                   device: DeviceLike = None) -> torch.Tensor:
    """Sequence-parallel attention: KV shards rotate around the ring.

    q/k/v are this rank's contiguous sequence shard (b, n/P, h, d) of the
    global sequence; the result is the matching shard of dense attention
    over the whole sequence. Every rank of ``group`` calls it."""
    group, rank, size = sequence_group(group)
    dev, (q, k, v) = _tensors(device, q, k, v)
    chunk = q.shape[1]
    _sequence_length(chunk, group, size, dev)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    out, row_max, row_sum = _init_stats(q)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(size):
        # the KV shard held at step i started at rank (rank - i)
        src = (rank - i) % size
        out, row_max, row_sum = _streamed_attend(
            q, kb, vb, out, row_max, row_sum, q_offset=rank * chunk,
            k_offset=src * chunk, causal=causal, scale=scale)
        if i + 1 < size:
            kb, vb = _rotate((kb, vb), group, rank, size)
    return _normalize(out, row_sum)


def _all_to_all(x, group):
    """(P, ...) -> (P, ...): part j goes to rank j, part i of the result
    came from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    sanitizer.record_collective("all_to_all", SEQUENCE_AXIS, x.shape,
                                x.dtype)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q, k, v, group: Optional[dist.ProcessGroup] = None,
                      causal: bool = False,
                      device: DeviceLike = None) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses): trade the sequence
    shard (b, n/P, h, d) for a head shard (b, n, h/P, d), run
    :func:`fused_attention` per head group, swap back."""
    group, _, size = sequence_group(group)
    dev, (q, k, v) = _tensors(device, q, k, v)
    b, chunk, h, d = q.shape
    if h % size:
        raise ValueError(f"heads {h} not divisible by sp={size}")
    n = _sequence_length(chunk, group, size, dev)
    hg = h // size

    def seq_to_heads(x):
        parts = x.reshape(b, chunk, size, hg, d).permute(2, 0, 1, 3, 4)
        return _all_to_all(parts, group).permute(1, 0, 2, 3, 4).reshape(
            b, n, hg, d)

    def heads_to_seq(x):
        parts = x.reshape(b, size, chunk, hg, d).permute(1, 0, 2, 3, 4)
        return _all_to_all(parts, group).permute(1, 2, 0, 3, 4).reshape(
            b, chunk, h, d)

    out = fused_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal=causal, device=dev)
    return heads_to_seq(out)


def dense_attention(q, k, v, causal: bool = False,
                    device: DeviceLike = None) -> torch.Tensor:
    """Reference dense softmax attention."""
    _, (q, k, v) = _tensors(device, q, k, v)
    nq, nk, d = q.shape[1], k.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d ** 0.5)
    if causal:
        mask = (torch.arange(nq, device=q.device)[:, None]
                >= torch.arange(nk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)

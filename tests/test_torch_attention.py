"""The port's attention plane on the CPU against the JAX package's:
the flash kernel's plain version (``flash_attention(device="cpu")``)
against the Pallas kernel in interpret mode, and ``dense_attention``,
``blockwise_attention``, ``_streamed_attend`` and ``fused_attention``
against their JAX twins, on the same seeded numpy inputs.

Tolerances are those of the JAX package's own tests: the flash kernel
``rtol=2e-4, atol=2e-5`` (``rtol=1e-3, atol=1e-4`` for scores far
outside exp's range, ``tests/parallel/test_flash.py``), the rest
``atol=1e-4`` (``tests/parallel/test_attention.py``). Both sides compute
in float32 and differ only in the order of their sums.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel import attention as jax_attn
from mmlspark_tpu.parallel.flash import flash_attention as jax_flash
from mmlspark_tpu_torch.parallel import attention as A
from mmlspark_tpu_torch.parallel import flash as F

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

CPU = "cpu"


def _qkv(b=2, n=64, h=4, d=8, nk=None, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    nk = n if nk is None else nk
    q = (rng.normal(size=(b, n, h, d)) * scale).astype(np.float32)
    k = (rng.normal(size=(b, nk, h, d)) * scale).astype(np.float32)
    v = rng.normal(size=(b, nk, h, d)).astype(np.float32)
    return q, k, v


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


# --- the flash kernel's plain version vs the Pallas kernel -----------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_kernel(causal):
    q, k, v = _qkv(b=2, n=64, h=2, d=16, seed=1)
    got = F.flash_attention(q, k, v, block_q=16, block_k=16, causal=causal,
                            device=CPU)
    want = jax_flash(q, k, v, block_q=16, block_k=16, causal=causal,
                     interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        _np(got), _np(jax_attn.dense_attention(q, k, v, causal=causal)),
        rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_cross_attention_lengths(causal):
    # kv longer than q, non-square blocking; causal stays top-left aligned
    q, _, _ = _qkv(b=1, n=32, h=2, d=8, seed=2)
    _, k, v = _qkv(b=1, n=96, h=2, d=8, seed=3)
    got = F.flash_attention(q, k, v, block_q=16, block_k=32, causal=causal,
                            device=CPU)
    want = jax_flash(q, k, v, block_q=16, block_k=32, causal=causal,
                     interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)


def test_flash_rejects_ragged_blocks():
    q = np.random.default_rng(4).normal(size=(1, 50, 1, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="divisible"):
        F.flash_attention(q, q, q, block_q=16, block_k=16, device=CPU)
    with pytest.raises(ValueError, match="divisible"):
        jax_flash(q, q, q, block_q=16, block_k=16, interpret=True)


def test_flash_numerical_stability_large_scores():
    # logits far outside exp()'s range: the online softmax must not overflow
    q, k, v = _qkv(b=1, n=32, h=1, d=8, seed=5, scale=30.0)
    got = _np(F.flash_attention(q, k, v, block_q=16, block_k=16,
                                device=CPU))
    assert np.isfinite(got).all()
    want = _np(jax_flash(q, k, v, block_q=16, block_k=16, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_flash_bfloat16_computes_in_float32_and_rounds_once():
    q, k, v = _qkv(b=1, n=32, h=2, d=16, seed=6)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = F.flash_attention(qb, kb, vb, block_q=16, block_k=16, causal=True,
                            device=CPU)
    assert got.dtype == torch.bfloat16
    want = F.flash_attention(qb.float(), kb.float(), vb.float(), block_q=16,
                             block_k=16, causal=True, device=CPU)
    assert torch.equal(got, want.bfloat16())
    # the Pallas kernel casts bf16 inputs to float32 and writes q's type
    ref = jax_flash(jnp.asarray(qb.float().numpy(), jnp.bfloat16),
                    jnp.asarray(kb.float().numpy(), jnp.bfloat16),
                    jnp.asarray(vb.float().numpy(), jnp.bfloat16),
                    block_q=16, block_k=16, causal=True, interpret=True)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(_np(ref)), 1e-30))) - 7)
    assert (np.abs(_np(got) - _np(ref)) <= ulp).all()


def test_flash_rejects_types_and_head_dims_outside_the_kernel():
    q, k, v = _qkv(b=1, n=16, h=1, d=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        F.flash_attention(q.astype(np.float64), k, v, device=CPU)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        F.flash_attention(torch.from_numpy(q).half(), torch.from_numpy(k),
                          torch.from_numpy(v), device=CPU)
    wide = np.zeros((1, 16, 1, 129), np.float32)
    with pytest.raises(ValueError, match="1..128"):
        F.flash_attention(wide, wide, wide, device=CPU)
    with pytest.raises(ValueError, match="kv_seq"):
        F.flash_attention(q, k[:, :, :, :4], v, device=CPU)


def test_kernel_path_refuses_inputs_that_require_grad():
    q, k, v = (torch.from_numpy(x) for x in _qkv(b=1, n=16, h=1, d=8))
    with pytest.raises(RuntimeError, match="no gradient"):
        F.check_kernel_inputs(q.requires_grad_(), k, v)
    # the plain version on the CPU is ordinary autograd
    out = F.flash_attention(q, k, v, block_q=16, block_k=16, device=CPU)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("the CPU path launched the kernel")
    monkeypatch.setattr(F, "_launch", no_launch)
    before = F.flash_kernel_launches
    q, k, v = _qkv(b=1, n=128, h=2, d=8)
    A.fused_attention(q, k, v, causal=True, device=CPU)
    assert F.flash_kernel_launches == before
    assert not F.flash_available(CPU)


# --- dense / blockwise / streamed / fused vs the JAX package ---------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk", [(64, 64), (32, 96)])
def test_dense_matches_jax(causal, n, nk):
    q, k, v = _qkv(n=n, nk=nk, seed=7)
    got = A.dense_attention(q, k, v, causal=causal, device=CPU)
    want = jax_attn.dense_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk,block", [
    (64, 64, 16),      # four blocks
    (32, 67, 16),      # prime kv length: one dense tile
    (40, 704, 512),    # 704 streams in 352-wide blocks
    (48, 48, 512),     # one block
])
def test_blockwise_matches_jax(causal, n, nk, block):
    q, k, v = _qkv(b=1, n=n, nk=nk, h=2, seed=8)
    got = A.blockwise_attention(q, k, v, block_size=block, causal=causal,
                                device=CPU)
    want = jax_attn.blockwise_attention(q, k, v, block_size=block,
                                        causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        _np(got), _np(jax_attn.dense_attention(q, k, v, causal=causal)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_streamed_attend_matches_jax(causal):
    # a rotated ring chunk: queries at global offset 32, keys at 16
    q, k, v = _qkv(b=1, n=16, nk=48, h=2, seed=9)
    b, n, h, _ = q.shape
    scale = 1.0 / np.sqrt(q.shape[-1])
    out0 = np.zeros_like(q)
    m0 = np.full((b, h, n), -1e30, np.float32)
    l0 = np.zeros((b, h, n), np.float32)
    got = A._streamed_attend(*(torch.from_numpy(x) for x in
                               (q, k, v, out0, m0, l0)),
                             q_offset=32, k_offset=16, causal=causal,
                             scale=scale, block_size=16)
    want = jax_attn._streamed_attend(
        *(jnp.asarray(x) for x in (q, k, v, out0, m0, l0)), q_offset=32,
        k_offset=16, causal=causal, scale=scale, block_size=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,nk", [(128, 256), (96, 96)])
def test_fused_matches_jax(causal, n, nk):
    q, k, v = _qkv(b=1, n=n, nk=nk, h=2, seed=10)
    got = A.fused_attention(q, k, v, causal=causal, device=CPU)
    want = jax_attn.fused_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,nk,route", [(128, 256, "flash"),
                                        (256, 128, "flash"),
                                        (96, 128, "blockwise"),
                                        (128, 96, "blockwise")])
def test_fused_routes_by_shape(monkeypatch, n, nk, route):
    taken = []
    flash_ref = F.flash_attention_reference
    blockwise = A.blockwise_attention
    monkeypatch.setattr(F, "flash_attention_reference",
                        lambda *a, **kw: taken.append("flash")
                        or flash_ref(*a, **kw))
    monkeypatch.setattr(A, "blockwise_attention",
                        lambda *a, **kw: taken.append("blockwise")
                        or blockwise(*a, **kw))
    q, k, v = _qkv(b=1, n=n, nk=nk, h=1, seed=11)
    A.fused_attention(q, k, v, device=CPU)
    assert taken == [route]


def test_entry_points_take_tensors_and_keep_their_type():
    q, k, v = (torch.from_numpy(x) for x in _qkv(b=1, n=32, h=2, d=8))
    for fn in (A.dense_attention, A.blockwise_attention, A.fused_attention):
        out = fn(q, k, v, device=CPU)
        assert out.dtype == torch.float32 and out.shape == q.shape
    out = A.blockwise_attention(q.double(), k.double(), v.double(),
                                device=CPU)
    assert out.dtype == torch.float64


# --- the CUDA kernel's walk, replayed on the CPU ---------------------------

def _kernel_replay(q, k, v, causal, skip=True):
    """``csrc/flash_attn.cu``'s walk in torch: one CTA per (batch*head,
    128-row q tile), 64-key tiles, d padded with zeros to its bucket, keys
    past nk masked, the mask applied only on the tiles that cross the
    causal diagonal or hold keys past nk (``skip``; every tile otherwise),
    and (``skip``) the CTA's last tile the last its rows can see. Where the
    mask is not applied, it is checked to mask nothing."""
    bq, bk = 128, 64
    b, n, h, d = q.shape
    nk = k.shape[1]
    dd = 32 if d <= 32 else 64 if d <= 64 else 128
    scale = float(np.float32(1.0 / np.sqrt(d)))
    out = torch.zeros((b, n, h, d))
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, n, bq):
                qs = torch.zeros(bq, dd)
                qt = q[bi, q0:q0 + bq, hi]
                qs[:qt.shape[0], :d] = qt * scale
                tiles = -(-nk // bk)
                if causal and skip:
                    tiles = min(tiles, (q0 + bq - 1) // bk + 1)
                m = torch.full((bq,), -1e30)
                l = torch.zeros(bq)
                acc = torch.zeros(bq, dd)
                q_pos = q0 + torch.arange(bq)
                for t in range(tiles):
                    k0 = t * bk
                    ks, vs = torch.zeros(bk, dd), torch.zeros(bk, dd)
                    kt, vt = k[bi, k0:k0 + bk, hi], v[bi, k0:k0 + bk, hi]
                    ks[:kt.shape[0], :d], vs[:vt.shape[0], :d] = kt, vt
                    k_pos = k0 + torch.arange(bk)
                    s = qs @ ks.T
                    masked = (k_pos[None, :] >= nk) | (
                        causal & (q_pos[:, None] < k_pos[None, :]))
                    if (not skip or (causal and k0 + bk - 1 > q0)
                            or k0 + bk > nk):
                        s = torch.where(masked, -1e30, s)
                    else:
                        assert not masked.any()
                    new_m = torch.maximum(m, s.amax(dim=1))
                    p = torch.exp(s - new_m[:, None])
                    corr = torch.exp(m - new_m)
                    l = l * corr + p.sum(dim=1)
                    m = new_m
                    acc = acc * corr[:, None] + p @ vs
                res = acc / torch.clamp(l, min=1e-30)[:, None]
                out[bi, q0:q0 + bq, hi] = res[:qt.shape[0], :d]
    return out


@pytest.mark.parametrize("n,nk,d", [(80, 100, 40), (200, 80, 16),
                                    (64, 192, 128), (128, 128, 64),
                                    (129, 127, 64), (127, 129, 33),
                                    (300, 65, 96), (1, 64, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_walk_replayed(n, nk, d, causal):
    """Ragged q and kv tiles (one row past a 128-row q tile, one key short
    of two 64-key tiles), head dims off the buckets, n != nk both ways:
    the kernel's walk gives the plain version's result, and skipping the
    tiles above the diagonal and the mask off it changes no bit."""
    q, k, v = (torch.from_numpy(x) for x in
               _qkv(b=1, n=n, nk=nk, h=2, d=d, seed=12))
    got = _kernel_replay(q, k, v, causal)
    want = F.flash_attention_reference(q, k, v, block_k=nk, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-5)
    assert torch.equal(got, _kernel_replay(q, k, v, causal, skip=False))

"""``csrc/flash_attn_sm90.cu`` (bfloat16 flash attention on Hopper's
tensor cores) on the CPU: a torch replay of its walk and arithmetic held
against the plain version and the Pallas kernel in interpret mode, its
P = P_hi + P_lo split, the route that picks it, and the TMA geometry the
wrapper passes to it.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the same plain version. The gate here is the card's: rtol 2e-4,
atol 2e-5, plus one bf16 step (both results are rounded once to bf16).
"""

import fnmatch
import itertools
import pathlib
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.flash import flash_attention as jax_flash
from mmlspark_tpu_torch.native import bindings
from mmlspark_tpu_torch.parallel import flash as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOG2E = 1.4426950408889634
BF16 = torch.bfloat16


def _qkv(b=1, n=64, nk=None, h=2, d=64, seed=0, scale=1.0):
    """Seeded normals rounded to bf16 (q and k times ``scale``)."""
    rng = np.random.default_rng(seed)
    nk = n if nk is None else nk
    q = rng.normal(size=(b, n, h, d)) * scale
    k = rng.normal(size=(b, nk, h, d)) * scale
    v = rng.normal(size=(b, nk, h, d))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(BF16)
                 for x in (q, k, v))


def _gate_misses(a, b, atol=2e-5, rtol=2e-4):
    """``chip_smoke.bf16_step_misses``: the outputs where |a - b| exceeds
    one bf16 step of the larger magnitude + atol + rtol*|b|."""
    a, b = a.double(), b.double()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), exp - 8)
    return int(((a - b).abs() > step + atol + rtol * b.abs()).sum())


def _within_bf16_step(a, b):
    return _gate_misses(a, b) == 0


def _exact(q, k, v, causal):
    """The function in float64 from the same (rounded) inputs, dense."""
    q, k, v = (x.double().transpose(1, 2) for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    if causal:
        n, nk = s.shape[-2:]
        s = s.masked_fill(torch.arange(nk)[None, :] > torch.arange(n)[:, None],
                          -np.inf)
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2)


def split_hi_lo(p):
    """The kernel's split of float32 P: P_hi = bf16(P), P_lo = bf16(P -
    P_hi), both rounded to nearest even, returned as float32."""
    hi = p.to(BF16).float()
    return hi, (p - hi).to(BF16).float()


def _sm90_replay(q, k, v, causal, mask_all=False, skip=True):
    """``flash_attn_sm90.cu``'s walk and arithmetic in torch: one CTA per
    (batch*head, 128-row q tile) as two consumer warpgroups of 64 rows,
    128-key tiles with rows past n or nk zero (TMA's
    fill), the raw bf16 products summed in float32 and multiplied by
    scale*log2(e) in float32, -1e30 on masked scores of the tiles that
    hold the diagonal or pass nk (``mask_all``: every tile), a base-2
    online softmax with l summed from the float32 P, O += P_hi V + P_lo V,
    and (``skip``) the tiles wholly above the CTA's last row skipped.
    Columns run to the instantiation's D (64 for d <= 64, else 128), those
    past d zero (TMA's fill), and only the first d are stored."""
    bq, bk, wg = 128, 128, 64
    b, n, h, d = q.shape
    nk = k.shape[1]
    D = 64 if d <= 64 else 128
    c = float(np.float32(np.float64(np.float32(1 / np.sqrt(d))) * LOG2E))
    out = torch.zeros((b, n, h, d), dtype=BF16)

    def padded(x, start, rows):
        tile = torch.zeros(rows, D)
        part = x[start:start + rows].float()
        tile[:part.shape[0], :d] = part
        return tile

    for bi, hi in itertools.product(range(b), range(h)):
        for q0 in range(0, n, bq):
            tiles = -(-nk // bk)
            if causal and skip:
                tiles = min(tiles, (min(q0 + bq, n) - 1) // bk + 1)
            for w0 in range(q0, min(q0 + bq, n), wg):
                qs = padded(q[bi, :, hi], w0, wg)
                q_pos = w0 + torch.arange(wg)
                m = torch.full((wg,), -1e30)
                l = torch.zeros(wg)
                o = torch.zeros(wg, D)
                for t in range(tiles):
                    k0 = t * bk
                    ks = padded(k[bi, :, hi], k0, bk)
                    vs = padded(v[bi, :, hi], k0, bk)
                    x = (qs @ ks.T) * c
                    if mask_all or k0 + bk > nk or (causal
                                                    and k0 + bk - 1 > w0):
                        k_pos = k0 + torch.arange(bk)
                        masked = (k_pos[None, :] >= nk) | (
                            causal & (k_pos[None, :] > q_pos[:, None]))
                        x = torch.where(masked, -1e30, x)
                    new_m = torch.maximum(m, x.amax(dim=1))
                    corr = torch.exp2(m - new_m)
                    p = torch.exp2(x - new_m[:, None])
                    l = l * corr + p.sum(dim=1)
                    p_hi, p_lo = split_hi_lo(p)
                    o = o * corr[:, None]
                    o = o + p_hi @ vs
                    o = o + p_lo @ vs
                    m = new_m
                res = o / torch.clamp(l, min=1e-30)[:, None]
                rows = min(wg, n - w0)
                out[bi, w0:w0 + rows, hi] = res[:rows, :d].to(BF16)
    return out


def _pallas(q, k, v, causal):
    n, nk = q.shape[1], k.shape[1]
    args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    out = jax_flash(*args, block_q=n, block_k=nk, causal=causal,
                    interpret=True)
    return torch.from_numpy(np.asarray(out, np.float32))


# --- the kernel's arithmetic, replayed --------------------------------------

@pytest.mark.parametrize("n,nk,d,scale", [
    (200, 300, 64, 1.0),     # ragged tiles, nk > n
    (300, 200, 128, 1.0),    # two column boxes, n > nk
    (256, 256, 64, 30.0),    # scores far outside exp's range
    (130, 260, 128, 30.0),
])
@pytest.mark.parametrize("causal", [False, True])
def test_replay_within_the_gate_of_plain_and_pallas(n, nk, d, scale, causal):
    q, k, v = _qkv(n=n, nk=nk, d=d, seed=n + nk + d, scale=scale)
    got = _sm90_replay(q, k, v, causal)
    assert got.dtype == BF16 and torch.isfinite(got.float()).all()
    assert _within_bf16_step(got, _pallas(q, k, v, causal))
    plain = F.flash_attention_reference(q, k, v, causal=causal)
    if scale == 1.0:
        assert _within_bf16_step(got, plain)
    else:
        # Scores x30 (|s| ~ 1e3): two float32 computations that sum q.k in
        # other orders (or, at d=128, round q * 1/sqrt(d) first, as the
        # plain version does) move outputs at near ties past the gate, the
        # plain version as well as the replay. Both are held to the float64
        # value, as chip_smoke.py holds the kernel: the replay may miss the
        # gate at no more outputs than the plain version does.
        exact = _exact(q, k, v, causal)
        assert _gate_misses(got, exact) <= _gate_misses(plain, exact)


@pytest.mark.parametrize("d", [16, 32, 36, 96, 8, 1, 127])
@pytest.mark.parametrize("causal", [False, True])
def test_replay_at_any_head_dim_within_the_gate(d, causal):
    """Head dims other than 64 and 128 run on the D=64 or D=128
    instantiation with the columns past d zero (TMA's fill; for 36, 1 and
    127, staging's zero padding to a multiple of 8 comes first, which adds
    nothing more): within the bf16 gate of the plain version and of the
    Pallas kernel."""
    q, k, v = _qkv(n=200, nk=300, d=d, seed=40 + d)
    got = _sm90_replay(q, k, v, causal)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert _within_bf16_step(got, F.flash_attention_reference(
        q, k, v, causal=causal))
    assert _within_bf16_step(got, _pallas(q, k, v, causal))


@pytest.mark.parametrize("n,nk,d", [(200, 300, 64), (300, 130, 128),
                                    (400, 400, 64)])
def test_masking_edge_tiles_only_and_the_causal_skip_are_exact(n, nk, d):
    """Tiles that neither hold the diagonal nor pass nk have no masked
    score, and tiles above the diagonal (all masked: p = 0 and a
    correction of 1) change no bit when walked."""
    q, k, v = _qkv(n=n, nk=nk, d=d, seed=3)
    got = _sm90_replay(q, k, v, causal=True)
    assert torch.equal(got, _sm90_replay(q, k, v, True, mask_all=True))
    assert torch.equal(got, _sm90_replay(q, k, v, True, skip=False))
    assert torch.equal(_sm90_replay(q, k, v, False),
                       _sm90_replay(q, k, v, False, mask_all=True))


def test_hi_lo_split_reconstructs_p_within_2_to_the_minus_16():
    rng = np.random.default_rng(7)
    p = np.concatenate([
        np.exp2(-rng.uniform(0, 40, 200_000)),          # softmax weights
        rng.uniform(0.5, 1.0, 100_000),
        1.0 + np.arange(1, 512) * 2.0 ** -9,             # bf16 ties
        [1.0, 2.0 ** -126, 0.5 + 2.0 ** -24]])
    p = torch.from_numpy(p.astype(np.float32))
    hi, lo = split_hi_lo(p)
    rel = ((hi + lo - p).abs() / p).max().item()
    assert rel <= 2.0 ** -16
    # one rounding alone is the error the split removes
    assert ((hi - p).abs() / p).max().item() > 2.0 ** -10


# --- which kernel a CUDA call launches --------------------------------------

def _route(q, k, v):
    return F.flash_route(q.dtype, q.shape[-1],
                         [t.data_ptr() for t in (q, k, v)],
                         [t.stride() for t in (q, k, v)])


def _bf16(*shape):
    return torch.zeros(shape, dtype=BF16)


@pytest.mark.parametrize("dtype,d,route", [
    (BF16, 64, "flash_attn_sm90"),
    (BF16, 128, "flash_attn_sm90"),
    (BF16, 16, "flash_attn_sm90"),
    (BF16, 32, "flash_attn_sm90"),
    (BF16, 96, "flash_attn_sm90"),
    (BF16, 8, "flash_attn_sm90"),
    (BF16, 36, "flash_attn_sm90+staged"),
    (BF16, 1, "flash_attn_sm90+staged"),
    (BF16, 127, "flash_attn_sm90+staged"),
    (torch.float32, 64, "flash_attn"),
    (torch.float32, 128, "flash_attn"),
    (torch.float32, 36, "flash_attn"),
])
def test_route_by_type_and_head_dim(dtype, d, route):
    q = torch.zeros((2, 256, 4, d), dtype=dtype)
    assert _route(q, q, q) == route


@pytest.mark.parametrize("part", [0, 1, 2])
def test_route_takes_a_packed_qkv_view(part):
    qkv = _bf16(2, 256, 3, 4, 64)
    t = qkv[:, :, part]
    assert t.stride() == (256 * 3 * 4 * 64, 3 * 4 * 64, 64, 1)
    assert _route(t, qkv[:, :, 1], qkv[:, :, 2]) == "flash_attn_sm90"


@pytest.mark.parametrize("offset,route", [(1, "flash_attn_sm90+staged"),
                                          (4, "flash_attn_sm90+staged"),
                                          (8, "flash_attn_sm90")])
def test_route_by_base_alignment(offset, route):
    flat = _bf16(2 * 256 * 4 * 64 + 8)
    q = flat[offset:offset + 2 * 256 * 4 * 64].view(2, 256, 4, 64)
    k = _bf16(2, 256, 4, 64)
    assert _route(q, k, k) == route
    assert _route(k, k, q) == route
    # float32 keeps flash_attn.cu, aligned or not
    flat32 = torch.zeros(2 * 256 * 4 * 64 + 8)
    q32 = flat32[offset:offset + 2 * 256 * 4 * 64].view(2, 256, 4, 64)
    k32 = torch.zeros((2, 256, 4, 64))
    assert _route(q32, k32, k32) == _route(k32, k32, q32) == "flash_attn"


def test_route_by_strides():
    wide = _bf16(2, 256, 4, 68)[..., :64]          # h stride 68
    k = _bf16(2, 256, 4, 64)
    assert _route(wide, k, k) == "flash_attn_sm90+staged"
    bhnd = _bf16(2, 4, 256, 64).transpose(1, 2)     # (b, h, n, d) in place
    assert _route(bhnd, k, k) == "flash_attn_sm90"
    shared = _bf16(1, 256, 4, 64).expand(2, -1, -1, -1)   # batch stride 0
    assert _route(k, shared, shared) == "flash_attn_sm90+staged"
    assert _route(k, k, k[..., ::2].contiguous()[..., :64]) == \
        "flash_attn_sm90"
    assert _route(k, k, _bf16(2, 256, 4, 128)[..., ::2]) == \
        "flash_attn_sm90+staged"                   # d not contiguous
    # float32 keeps flash_attn.cu whatever its strides
    for t in (wide, bhnd, shared):
        t32 = t.float() if t is not shared else \
            torch.zeros((1, 256, 4, 64)).expand(2, -1, -1, -1)
        assert _route(t32, k.float(), k.float()) == "flash_attn"


def test_launch_dispatches_by_the_route(monkeypatch):
    """``_launch`` hands a call to the launcher its route names, and only
    the launchers count launches (each where it launches its kernel)."""
    taken = []
    monkeypatch.setattr(F, "_launch_sm90", lambda *a: taken.append("sm90"))
    monkeypatch.setattr(F, "_launch_simt", lambda *a: taken.append("simt"))
    before = (F.flash_kernel_launches, F.flash_sm90_launches)
    qkv = _bf16(1, 128, 3, 2, 64)
    F._launch(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True)
    F._launch(*(torch.zeros((1, 128, 2, 64)),) * 3, causal=False)
    flat = _bf16(128 * 2 * 64 + 1)[1:].view(1, 128, 2, 64)
    F._launch(flat, flat, flat, causal=False)
    # a view whose last dim is not contiguous is staged first
    F._launch(*(_bf16(1, 128, 2, 128)[..., ::2],) * 3, causal=True)
    assert taken == ["sm90", "simt", "sm90", "sm90"]
    assert (F.flash_kernel_launches, F.flash_sm90_launches) == before


@pytest.mark.parametrize("d", [64, 36, 1, 127])
def test_staging_copies_bitwise_and_zero_pads(d):
    """stage_for_tma: a fresh contiguous (b, n, h, d8) tensor, 16-byte
    aligned, holding the input's bits in its first d columns and zeros in
    the rest, from a misaligned strided view."""
    src = torch.from_numpy(np.random.default_rng(d).normal(
        size=(2, 40, 3, 2 * d + 1)).astype(np.float32)).to(BF16)
    view = src[..., 1:2 * d + 1:2]                    # misaligned, strided
    assert view.data_ptr() % 16 and view.stride(-1) == 2
    staged = F.stage_for_tma(view)
    d8 = -(-d // 8) * 8
    assert staged.shape == (2, 40, 3, d8) and staged.is_contiguous()
    assert staged.data_ptr() % 16 == 0 and staged.dtype == BF16
    assert torch.equal(staged[..., :d].view(torch.int16),
                       view.contiguous().view(torch.int16))
    assert not staged[..., d:].view(torch.int16).any()
    assert _route(staged, staged, staged) == "flash_attn_sm90"


def test_staged_calls_are_counted(monkeypatch):
    """A misaligned bf16 call, or one of d = 36, stages its inputs and
    launches flash_attn_sm90 on them with the true d, and bumps
    ``flash_staged_calls``; an aligned call does neither."""
    seen = []
    monkeypatch.setattr(F, "_launch_sm90", lambda q, k, v, out, causal,
                        geom, d: seen.append((q.shape[-1], d, geom[0],
                                              q.data_ptr() % 16)))
    before = F.flash_staged_calls
    flat = _bf16(128 * 2 * 64 + 1)[1:].view(1, 128, 2, 64)
    F._launch(flat, flat, flat, causal=True)
    assert F.flash_staged_calls == before + 1
    F._launch(*(_bf16(1, 128, 2, 36),) * 3, causal=False)
    assert F.flash_staged_calls == before + 2
    F._launch(*(_bf16(1, 128, 2, 32),) * 3, causal=False)
    assert F.flash_staged_calls == before + 2
    assert seen == [(64, 64, 64, 0), (40, 36, 40, 0), (32, 32, 32, 0)]


def test_cpu_bf16_calls_take_the_plain_version():
    before = (F.flash_kernel_launches, F.flash_sm90_launches)
    q, k, v = _qkv(n=128, d=64, seed=5)
    out = F.flash_attention(q, k, v, causal=True, device="cpu")
    assert out.dtype == BF16
    assert torch.equal(out, F.flash_attention_reference(q, k, v,
                                                        causal=True))
    assert (F.flash_kernel_launches, F.flash_sm90_launches) == before


# --- the TMA geometry passed to the C side ----------------------------------

@pytest.mark.parametrize("d", [64, 128, 16, 32, 40, 96])
def test_tma_geometry_of_a_contiguous_tensor(d):
    b, n, h = 2, 300, 4
    t = _bf16(b, n, h, d)
    g = F.tma_geometry(tuple(t.shape), t.stride(), t.element_size(), 128)
    assert g == {"dims": (d, h, n, b),
                 "strides": (2 * d, 2 * h * d, 2 * n * h * d),
                 "box": (64, 1, 128, 1), "swizzle": 128}


def test_tma_geometry_of_strided_views():
    qkv = _bf16(2, 300, 3, 4, 64)
    q = qkv[:, :, 0]
    g = F.tma_geometry(tuple(q.shape), q.stride(), 2, 128)
    assert g["dims"] == (64, 4, 300, 2)
    assert g["strides"] == (128, 2 * 3 * 4 * 64, 2 * 300 * 3 * 4 * 64)
    bhnd = _bf16(2, 4, 300, 128).transpose(1, 2)
    g = F.tma_geometry(tuple(bhnd.shape), bhnd.stride(), 2, 128)
    assert g["dims"] == (128, 4, 300, 2)
    assert g["strides"] == (2 * 300 * 128, 2 * 128, 2 * 4 * 300 * 128)
    assert g["box"] == (64, 1, 128, 1) and g["swizzle"] == 128


@pytest.mark.parametrize("d", [64, 128, 32, 96])
def test_the_launch_geometry_packs_q_k_v_in_order(d):
    """The C array the launcher passes: per tensor dims, byte strides, box
    (128 rows: the CTA's q rows, 64 per consumer warpgroup, or a key
    tile's) and swizzle; None where the route's layout rules fail."""
    q, k = _bf16(1, 256, 2, d), _bf16(1, 512, 2, d)
    args = list(F._sm90_geometry(BF16, q.shape, q.stride(), k.shape,
                                 k.stride(), k.stride()))
    assert len(args) == 36
    assert args[:12] == [d, 2, 256, 1, 2 * d, 4 * d, 256 * 4 * d, 64, 1,
                         128, 1, 128]
    assert args[12:16] == [d, 2, 512, 1] and args[21] == 128
    assert args[12:24] == args[24:]
    wide = _bf16(1, 256, 2, d + 4)[..., :d]
    assert F._sm90_geometry(BF16, wide.shape, wide.stride(), k.shape,
                            k.stride(), k.stride()) is None
    assert F._sm90_geometry(torch.float32, q.shape, q.stride(), k.shape,
                            k.stride(), k.stride()) is None


# --- build inputs ------------------------------------------------------------

def test_library_hash_covers_the_included_headers(monkeypatch, tmp_path):
    names = [p.name for p in bindings.sources("flash_attn_sm90")]
    assert names == ["flash_attn_sm90.cu", "sm90_wgmma.cuh"]
    for p in bindings.sources("flash_attn_sm90"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(bindings, "CSRC", tmp_path)
    before = bindings.library_path("flash_attn_sm90")
    with open(tmp_path / "sm90_wgmma.cuh", "a") as f:
        f.write("\n")
    assert bindings.library_path("flash_attn_sm90") != before


def test_package_data_ships_every_kernel_source():
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["mmlspark_tpu_torch"]
    csrc = ROOT / "mmlspark_tpu_torch" / "csrc"
    files = [f"csrc/{p.name}" for p in csrc.iterdir()]
    assert files and all(any(fnmatch.fnmatch(f, g) for g in globs)
                         for f in files)
    for name in bindings.SIGNATURES:
        assert all(p.exists() for p in bindings.sources(name))

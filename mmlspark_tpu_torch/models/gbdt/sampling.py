"""Row and feature sampling of the boosting step: bagging, pos/neg
bagging, ``feature_fraction``, GOSS and rf's bag; and the tree builder's
draws per level: ``extra_trees``' candidate bins and
``feature_fraction_by_node``'s node features.

The JAX package draws these inline in its fused step
(``mmlspark_tpu/models/gbdt/trainer.py`` ``_make_step_fn``) from
``jax.random`` streams keyed as

  - bagging: ``(seed, 1, bagging_seed, it - it % bagging_freq)`` (rf
    without ``bagging_freq``: iteration 0, one fixed bag);
  - feature fraction: ``(seed, 2, feature_fraction_seed, it)``;
  - GOSS: ``(seed, 3, it)``;
  - class c's tree (``extra_trees``, ``feature_fraction_by_node``):
    ``(seed, 4 + c, extra_seed, it)``, then per level ``d`` the
    candidate bins ``(..., d)`` and the node features ``(..., 101, d)``
    (``trainer.py:2208-2211``, ``:1643``, ``:1660``);

``it`` being the global iteration (``iteration_offset`` included), so a
resumed segment draws what the uninterrupted fit drew. The port keys its
draws the same way. Its draw (:func:`draw`) is a counter-based hash, a
pure function of the key and the row index written in int64 torch ops
whose products stay under 2^49 and whose results are masked to 32 bits:
the same bits on the CPU and on the card, and safe under CUDA graph
capture (the iteration may be a device scalar). ``torch.Generator``
would not do: its CPU and CUDA streams differ (mt19937, Philox).

The mask functions are plain functions of the draws, as the reference
writes them. Tests replace :func:`draw` (looked up as a module attribute
at every call) with ``jax.random``'s draws for the same keys, which
makes a sampled fit comparable with the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

M32 = 0xFFFFFFFF
BAG, FEATURES, GOSS, TREE = 1, 2, 3, 4   # the reference's stream ids
NODE_FEATURES = 101     # a tree's per-node feature stream, before the level


def _mul32(x, c: int):
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32) (a Python int or an
    int64 tensor) and a constant ``c`` < 2^32, by 16-bit halves of ``c``
    so no product reaches 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def mix32(h):
    """murmur3's 32-bit finalizer (a bijection of [0, 2^32)), on Python
    ints and int64 tensors alike."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def stream_key(keys: Sequence):
    """Fold a key chain, ``(seed, stream, ...)``, into one 32-bit key, as
    ``jax.random.fold_in`` folds the reference's. Entries are Python ints
    or int64 tensors (0-d, e.g. the iteration on the card); the result
    is a Python int while every entry so far is one."""
    h = 0x6A09E667
    for v in keys:
        h = mix32(((h ^ (v & M32)) + 0x9E3779B9) & M32)
    return h


def counter_uniform(keys: Sequence, n: int,
                    device: torch.device) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1) for the key chain ``keys``: row
    ``r`` takes ``mix32(mix32(key + r) ^ key2)`` (``key2`` a second hash
    of the key), whose top 24 bits scaled by 2^-24 are exact in
    float32."""
    key = stream_key(keys)
    key2 = mix32(key ^ 0x5BD1E995)
    rows = torch.arange(n, dtype=torch.int64, device=device)
    h = mix32(mix32((rows + key) & M32) ^ key2)
    return (h >> 8).to(torch.float32) * 2.0 ** -24


# The draw of every mask below: keys -> (n,) float32 uniforms. A module
# attribute, read at each call, so a test can put jax.random's in.
draw = counter_uniform


def bag_active(cfg) -> bool:
    """Whether the fit bags rows (the reference's ``bag_active``)."""
    return ((cfg.bagging_freq > 0
             and (cfg.bagging_fraction < 1.0 or _pos_neg(cfg)))
            or cfg.boosting_type == "rf")


def _pos_neg(cfg) -> bool:
    return cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0


def bag_keys(cfg, it):
    """The bagging stream's keys at iteration ``it`` (int or device
    scalar): the bag is redrawn every ``bagging_freq`` iterations, and
    rf without a frequency keeps the bag of iteration 0."""
    ref_it = it - it % cfg.bagging_freq if cfg.bagging_freq > 0 else 0
    return (cfg.seed, BAG, cfg.bagging_seed, ref_it)


def bag_mask(draw_: torch.Tensor, labels: torch.Tensor, cfg,
             row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) float32 0/1 bag: ``draw < fraction`` per row, the fraction
    per class under pos/neg bagging (binary labels > 0 are positive),
    rf's ``bagging_fraction`` or 0.632 where that is 1; times
    ``row_valid`` where given (``trainer.py:2143-2151``)."""
    if _pos_neg(cfg) and cfg.boosting_type != "rf":
        thr = torch.where(labels > 0, cfg.pos_bagging_fraction,
                          cfg.neg_bagging_fraction)
        mask = (draw_ < thr).to(torch.float32)
    else:
        frac = cfg.bagging_fraction
        if cfg.boosting_type == "rf" and frac >= 1.0:
            frac = 0.632
        mask = (draw_ < frac).to(torch.float32)
    return mask if row_valid is None else mask * row_valid


def feature_keep(num_f: int, fraction: float) -> int:
    """Features a tree may split on: ``max(1, round(F * fraction))``."""
    return max(1, int(round(num_f * fraction)))


def feature_keys(cfg, it):
    return (cfg.seed, FEATURES, cfg.feature_fraction_seed, it)


def feature_mask(draw_: torch.Tensor, num_f: int, keep: int) -> torch.Tensor:
    """(F,) float32 0/1 mask of the ``keep`` features first in the
    permutation that sorts ``draw_`` (stable), as the reference keeps
    ``permutation(key, F)[:keep]`` (``trainer.py:2154-2160``)."""
    perm = torch.argsort(draw_, stable=True)
    mask = torch.zeros(num_f, dtype=torch.float32, device=draw_.device)
    return mask.index_fill_(0, perm[:keep], 1.0)


def goss_keys(cfg, it):
    return (cfg.seed, GOSS, it)


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """0-d float32 ``jnp.nanquantile(x, q)`` (linear method) of a 1-d
    float32 tensor, with no size limit (``torch.nanquantile`` refuses
    more than 2^24 elements): NaNs sort last and are not counted;
    ``q * (count - 1)`` in float32 splits into the two neighbours and
    their weights, and the blend ``low * (1 - w) + high * w`` is rounded
    once on the second product, as the fused multiply-add XLA makes of
    it. The count is exact (an int64 sum); JAX's float32 count is too
    below 2^24 rows. No host sync: the neighbours are gathered by
    device indices."""
    s = torch.sort(x).values
    count = (~torch.isnan(x)).sum().to(torch.float32)
    pos = (count - 1.0) * q
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    last = count - 1.0

    def at(p):
        idx = torch.minimum(torch.clamp_min(p, 0.0), last).to(torch.int64)
        return torch.gather(s, 0, idx.reshape(1))[0]

    lo_v, hi_v = at(low), at(high)
    return (hi_v.double() * w_high.double()
            + (lo_v * w_low).double()).float()


def goss_mult(g: torch.Tensor, draw_: torch.Tensor,
              row_valid: Optional[torch.Tensor], cfg) -> torch.Tensor:
    """(N,) float32 GOSS multipliers (``trainer.py:2182-2195``): 1 for
    rows whose |g| reaches the ``1 - top_rate`` quantile of the valid
    rows' |g|, ``(1 - top_rate) / other_rate`` for a draw of the rest
    at rate ``other_rate / (1 - top_rate)``, else 0. For (N, K) grads
    (multiclass) a row's |g| is the sum over its classes, added in class
    order as XLA's reduction adds them; the caller scales every class."""
    absg = torch.abs(g)
    if absg.ndim == 2:
        total = absg[:, 0]
        for c in range(1, absg.shape[1]):
            total = total + absg[:, c]
        absg = total
    vals = absg if row_valid is None else torch.where(
        row_valid > 0, absg, torch.nan)
    thr = nanquantile(vals, 1.0 - cfg.top_rate)
    big = absg >= thr
    small_keep = draw_ < (cfg.other_rate / max(1.0 - cfg.top_rate, 1e-12))
    amplify = (1.0 - cfg.top_rate) / max(cfg.other_rate, 1e-12)
    return torch.where(big, 1.0, torch.where(small_keep, amplify, 0.0))


def tree_keys(cfg, cls: int, it):
    """The keys of class ``cls``'s tree at iteration ``it``, which its
    per-level draws extend."""
    return (cfg.seed, TREE + cls, cfg.extra_seed, it)


def extra_bins(draw_: torch.Tensor, b: int) -> torch.Tensor:
    """(width, F) int64 candidate bins in [0, b - 1), one per node and
    feature (``extra_trees``; the reference's ``randint(0, b - 1)``,
    ``trainer.py:1658-1662``): ``floor(draw * (b - 1))``, the product
    taken in float64, so exact and below b - 1."""
    return (draw_.double() * (b - 1)).long()


def node_feature_mask(draw_: torch.Tensor, feat_mask: Optional[torch.Tensor],
                      fraction: float) -> torch.Tensor:
    """(width, F) bool: each node's features under
    ``feature_fraction_by_node`` (``trainer.py:1636-1653``). A node keeps
    the ``keep_n`` features of the tree's (``feat_mask > 0``, every one
    where None) whose (width, F) draws are largest, ``keep_n = max(1,
    round_half_even(avail * fraction))`` with ``avail`` the tree's
    feature count, a device sum: no host sync."""
    width, f = draw_.shape
    fm = (torch.ones(f, dtype=torch.bool, device=draw_.device)
          if feat_mask is None else feat_mask > 0)
    avail = fm.sum().to(torch.float32)
    keep_n = torch.clamp_min(torch.round(avail * fraction), 1).long()
    masked = torch.where(fm[None, :], draw_, -1.0)
    ranked = torch.sort(masked, dim=1, descending=True).values
    kth = torch.gather(ranked, 1, (keep_n - 1).reshape(1, 1).expand(width, 1))
    return fm[None, :] & (masked >= kth)

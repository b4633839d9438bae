"""Exclusive feature bundling (EFB) for histogram construction: the
port's copy of the JAX package's ``mmlspark_tpu/ops/efb.py`` (the same
plans and bundled matrices, bit for bit, worked out with torch ops on
the matrix's device), plus the plan's index maps there.

LightGBM's EFB (arXiv:1706.08359 §4; io/dataset.cc FeatureGroup
construction): sparse features that are rarely non-default at the same
time are packed into one physical column, so every histogram pass
scans F_bundled << F columns. This is the strict zero-conflict variant:
two features share a bundle only if NO row has both non-default, so
bundled histograms are exactly recoverable:

  - each bundle member gets a contiguous slot range in the bundled
    column (offset + dense code over its observed non-default bins);
    slot 0 means "every member at its default bin";
  - unbundling scatters slots back to (original feature, original bin)
    with the plan's index maps, and reconstructs each member's
    default-bin stats as the node total minus its present bins (every
    live row contributes exactly once per bundled column, so the total
    is shared across columns);
  - bundled values stay < n_bins, so the bundled matrix keeps the
    original ingest dtype and the histogram shape keeps the same B.

The plan is built once per fit on the fit's binned tensor, on its own
device (``plan_bundles``), and applied there by ``apply_plan``; the
bundled matrix sits beside the original, histograms read the bundled
one, and trees record ORIGINAL feature ids: bundling is invisible
outside histogram construction.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.env import EFB, env_str, warn_once

_VALID_EFB = ("auto", "off", "on")


def resolve_efb() -> str:
    """EFB policy (``MMLSPARK_TORCH_EFB``, default auto): ``auto`` gates
    the planner on a sampled sparsity estimate (dense data skips
    planning in milliseconds), ``on`` runs the full conflict scan
    regardless, ``off`` disables bundling. A bad value warns once and
    runs ``auto``, as the JAX package's ``resolve_efb``."""
    raw = (env_str(EFB, "") or "").strip().lower()
    if not raw:
        return "auto"
    if raw not in _VALID_EFB:
        warn_once(EFB, f"{EFB}={raw!r} is not one of auto|off|on; using "
                       "auto")
        return "auto"
    return raw


@dataclass(frozen=True)
class BundleMember:
    feature: int          # original feature id
    default_bin: int      # bin reconstructed as total - present
    offset: int           # slot range start within the bundled column
    vals: Tuple[int, ...]  # observed non-default bins, slot o+1+j -> vals[j]


@dataclass(frozen=True)
class EFBPlan:
    n_features: int
    n_bins: int
    passthrough: Tuple[int, ...]            # original ids, col = position
    bundles: Tuple[Tuple[BundleMember, ...], ...]  # cols P..P+K-1

    @property
    def n_cols(self) -> int:
        return len(self.passthrough) + len(self.bundles)

    @property
    def n_bundled_features(self) -> int:
        return sum(len(bd) for bd in self.bundles)

    @property
    def cache_key(self) -> str:
        """Stable fingerprint of the plan: two different plans must never
        share a captured step."""
        h = hashlib.sha1()
        h.update(repr((self.n_features, self.n_bins, self.passthrough,
                       self.bundles)).encode())
        return h.hexdigest()

    def scatter_arrays(self):
        """(col, bundled_bin, feature, original_bin) int arrays, one
        entry per non-default slot across all bundles."""
        cols, bins, feats, obins = [], [], [], []
        p = len(self.passthrough)
        for bi, bundle in enumerate(self.bundles):
            for m in bundle:
                for j, v in enumerate(m.vals):
                    cols.append(p + bi)
                    bins.append(m.offset + 1 + j)
                    feats.append(m.feature)
                    obins.append(v)
        return (np.asarray(cols, np.int32), np.asarray(bins, np.int32),
                np.asarray(feats, np.int32), np.asarray(obins, np.int32))

    def member_default_arrays(self):
        """(feature, default_bin) for every bundled member."""
        feats = [m.feature for bd in self.bundles for m in bd]
        bins = [m.default_bin for bd in self.bundles for m in bd]
        return np.asarray(feats, np.int32), np.asarray(bins, np.int32)

    def passthrough_arrays(self):
        """(bundled col, original feature) for unbundled columns."""
        return (np.arange(len(self.passthrough), dtype=np.int32),
                np.asarray(self.passthrough, np.int32))


# the index maps' names, in the order of scatter_arrays,
# member_default_arrays and passthrough_arrays, then each member's run
# of scatter entries [md_start, md_end)
MAP_NAMES = ("sc_col", "sc_bin", "sc_feat", "sc_obin", "md_feat", "md_bin",
             "pt_col", "pt_feat", "md_start", "md_end")


def device_maps(plan: EFBPlan, device) -> Dict[str, torch.Tensor]:
    """The plan's index maps as int64 tensors on ``device`` (one copy
    each, made where a host-to-device copy is allowed: never inside a
    CUDA graph capture). A member's scatter entries are consecutive
    (bundle by bundle, member by member), ``md_start`` / ``md_end``
    bound them."""
    ends = np.cumsum([len(m.vals) for bd in plan.bundles for m in bd],
                     dtype=np.int64)
    starts = ends - [len(m.vals) for bd in plan.bundles for m in bd]
    arrays = (*plan.scatter_arrays(), *plan.member_default_arrays(),
              *plan.passthrough_arrays(), starts, ends)
    return {name: torch.as_tensor(np.asarray(a, np.int64), device=device)
            for name, a in zip(MAP_NAMES, arrays)}


@functools.lru_cache(maxsize=4)
def _sample_rows(n: int, size: int, seed: int) -> np.ndarray:
    """The rows of the planner's sample, ``default_rng(seed).choice(n,
    size, replace=False)`` as the reference draws them (a permutation's
    worth of work, some 40 ms at n = 2M), kept for the next fit of the
    same size. Sorted: the sample is read as a set (modes and shares),
    and rows in order gather faster."""
    rows = np.sort(np.random.default_rng(seed).choice(n, size=size,
                                                      replace=False))
    rows.setflags(write=False)
    return rows


def _ids(binned: torch.Tensor, rows=slice(None),
         cols=slice(None)) -> torch.Tensor:
    """int64 bin ids of ``binned[rows][:, cols]``: uint8 and int32 as
    they are, uint16 through its int16 view (torch indexes no uint16)."""
    wide = binned.dtype == torch.uint16
    part = (binned.view(torch.int16) if wide else binned)[rows][:, cols]
    return part.long() & 0xFFFF if wide else part.long()


def plan_bundles(binned: torch.Tensor, n_bins: int, mode: str = "auto",
                 sample_rows: int = 100_000, seed: int = 0,
                 block: int = 1 << 25) -> Optional[EFBPlan]:
    """One-shot bundling plan for an (N, F) binned tensor with ids below
    ``n_bins``, worked out on its own device, or ``None`` when bundling
    won't help (dense data, no conflict-free pairs, or ``mode ==
    "off"``): the reference's plan, bit for bit.

    ``auto`` only considers columns whose sampled non-default fraction
    is below 0.5 and gives up immediately when fewer than two qualify —
    uniformly dense data exits after one pass over the sample. ``on``
    treats every column with at least one default-bin row as a
    candidate. Conflict detection is EXACT over all rows: a sampled
    conflict graph could pack two features that collide on an unseen
    row, which would corrupt histograms rather than merely lose a little
    speed. One pass over the candidates' columns, ``block`` ids at a
    time, counts each column's bins (its non-default values and their
    rows) and forms the pairwise conflict matrix as a product of the
    0/1 non-default masks (a sum of non-negative terms, positive iff a
    row has both non-default). The greedy first-fit over descending
    density then runs on the host over that (C, C) matrix: a feature
    conflicts with a bundle iff it conflicts with one of its members,
    which is what the reference's AND of packed masks decides."""
    if mode == "off":
        return None
    n, f = binned.shape
    if n == 0 or f < 2:
        return None
    dev = binned.device
    sample = (_ids(binned, torch.tensor(_sample_rows(n, sample_rows, seed),
                                        device=dev))
              if n > sample_rows else _ids(binned))
    if int(sample.max()) >= n_bins:
        raise ValueError(f"bin id {int(sample.max())} is not below "
                         f"n_bins={n_bins}")
    # per-column mode over the sample: the reconstruction-by-subtraction
    # bin (any bin is a valid default; the first of the most frequent,
    # as numpy's argmax picks it)
    freq = torch.bincount(
        (sample + torch.arange(f, device=dev) * n_bins).view(-1),
        minlength=f * n_bins).view(f, n_bins)
    defaults = freq.argmax(dim=1)
    # the share of non-default rows (exact counts over the sample size,
    # as a mean of booleans gives them)
    nondefault_frac = ((len(sample) - freq.gather(1, defaults[:, None])[:, 0])
                       .cpu().numpy() / len(sample))
    thresh = 1.0 if mode == "on" else 0.5
    candidates = [j for j in range(f) if nondefault_frac[j] < thresh]
    if len(candidates) < 2:
        return None

    c = len(candidates)
    cand = torch.as_tensor(candidates, device=dev)
    cdef = defaults[cand]
    offsets = torch.arange(c, device=dev) * n_bins
    counts = torch.zeros(c * n_bins, dtype=torch.int64, device=dev)
    conflict = torch.zeros((c, c), dtype=torch.float32, device=dev)
    hi = torch.zeros((), dtype=torch.int64, device=dev)
    step = max(1, block // c)
    for r in range(0, n, step):
        ids = _ids(binned, slice(r, r + step), cand)           # (R, C)
        hi = torch.maximum(hi, ids.max())
        counts += torch.bincount((ids + offsets).view(-1),
                                 minlength=c * n_bins)[:c * n_bins]
        nz = (ids != cdef).float()
        conflict += nz.T @ nz
    if int(hi) >= n_bins:
        raise ValueError(f"bin id {int(hi)} is not below n_bins={n_bins}")
    counts = counts.view(c, n_bins)
    nonzero = (n - counts.gather(1, cdef[:, None])[:, 0]).cpu().numpy()
    seen = counts > 0
    seen[torch.arange(c, device=dev), cdef] = False
    seen = seen.cpu().numpy()
    conflicts = (conflict > 0).cpu().numpy()
    defaults = defaults.cpu().numpy()
    pos = {j: i for i, j in enumerate(candidates)}
    vals = {j: tuple(int(v) for v in np.flatnonzero(seen[pos[j]]))
            for j in candidates}

    # greedy first-fit decreasing: densest features first claim slots;
    # a feature joins a bundle iff it conflicts with NO member and the
    # bundle's slot budget keeps values < n_bins
    order = sorted(candidates, key=lambda j: (-int(nonzero[pos[j]]), j))
    slot_budget = n_bins - 1   # slot 0 = all-default
    bundle_feats: List[List[int]] = []
    bundle_conflicts: List[np.ndarray] = []
    bundle_used: List[int] = []
    for j in order:
        need = len(vals[j])
        if need > slot_budget:
            continue
        placed = False
        for bi in range(len(bundle_feats)):
            if bundle_used[bi] + need > slot_budget:
                continue
            if bundle_conflicts[bi][pos[j]]:
                continue
            bundle_feats[bi].append(j)
            bundle_conflicts[bi] |= conflicts[pos[j]]
            bundle_used[bi] += need
            placed = True
            break
        if not placed:
            bundle_feats.append([j])
            bundle_conflicts.append(conflicts[pos[j]].copy())
            bundle_used.append(need)

    real = [sorted(bf) for bf in bundle_feats if len(bf) >= 2]
    if not real:
        return None
    bundled_set = {j for bf in real for j in bf}
    passthrough = tuple(j for j in range(f) if j not in bundled_set)
    bundles = []
    for bf in real:
        members, off = [], 0
        for j in bf:
            members.append(BundleMember(feature=j,
                                        default_bin=int(defaults[j]),
                                        offset=off, vals=vals[j]))
            off += len(vals[j])
        bundles.append(tuple(members))
    return EFBPlan(n_features=f, n_bins=n_bins,
                   passthrough=passthrough, bundles=tuple(bundles))


def apply_plan(binned: torch.Tensor, plan: EFBPlan) -> torch.Tensor:
    """(N, F) original bins -> (N, n_cols) bundled matrix, a uint8,
    uint16 or int32 tensor on its own device in the same dtype (bundled
    codes stay < n_bins): the reference's ``apply_plan``, one pass of torch
    ops per bundle member. Zero conflicts make member codes disjoint, so
    they add. Ids must lie below ``plan.n_bins``. Makes small
    host-to-device copies (the members' code tables): never call it
    inside a CUDA graph capture."""
    wide = binned.dtype == torch.uint16
    bits = binned.view(torch.int16) if wide else binned
    out = torch.zeros((binned.shape[0], plan.n_cols), dtype=bits.dtype,
                      device=binned.device)
    if plan.passthrough:
        out[:, :len(plan.passthrough)] = bits[:, list(plan.passthrough)]
    p = len(plan.passthrough)
    for bi, bundle in enumerate(plan.bundles):
        codes = np.zeros((len(bundle), plan.n_bins), np.int64)
        for i, m in enumerate(bundle):
            codes[i, list(m.vals)] = m.offset + 1 + np.arange(len(m.vals))
        codes = torch.as_tensor(codes, device=binned.device)
        col = torch.zeros(binned.shape[0], dtype=torch.int64,
                          device=binned.device)
        for i, m in enumerate(bundle):
            src = bits[:, m.feature].long()
            col += codes[i][src & 0xFFFF if wide else src]
        out[:, p + bi] = col.to(bits.dtype)
    return out.view(torch.uint16) if wide else out

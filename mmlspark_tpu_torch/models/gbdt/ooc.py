"""Out-of-core GBDT training on PyTorch: chunked boosting over a spill
directory — the port of the JAX package's ``models/gbdt/ooc.py``.

The in-core trainer holds the (N, F) binned matrix, the raw-score carry
and each round's grad/hess on the device for the whole fit. This module
runs the same boosting loop over fixed-size row chunks read from a
``SpillReader`` directory (``ops/ingest.py``), so host and device memory
are bounded by the chunk, not by N: the counterpart of LightGBM's
external-memory training for fits of 100M rows and more.

Exactness: the streamed fit grows **bitwise** the trees of the in-core
fit on the same bins, on the quantized plane (``MMLSPARK_TORCH_HIST_QUANT``
q16 or q8; ``off`` is promoted to q16 with one warning, as in the
reference, since float32 sums do not merge exactly across chunks):

  - per round, grad/hess are integers under one power-of-two scale pair
    (``trainer._pow2_scale`` of the amax over every chunk), and each
    level's chunks add their integer sums into one int64 accumulator on
    the device through the quantized kernel's chunk-merge entry
    (``hist_cuda.level_histogram_quant_sums``: ``csrc/level_hist_quant.cu``
    with no dequantization). Integer sums commute, so the merged sums
    are the one pass's; they are dequantized once per level
    (``hist_cuda.dequantize_sums``) by the kernel's own expression. The
    reference merges on the host in float64 (``ooc.py:210-244``);
  - the root stats, sibling derivation, split finding and the level's
    record are the calls ``trainer.build_tree`` makes
    (``_root_stats``, ``_derive_sibling_hist``, ``_find_numeric_splits``,
    ``_record_level``), on the card, on the same histograms;
  - routing replays the builder's integer compares per chunk, and the
    carry update is ``Step.add_trees``'s: ``node_value * lr`` (a float32
    device scalar), ``trainer._predict_tree``, then an in-place add.

Each tree makes these passes over the chunks, each through a
``BatchPrefetcher`` (``parallel/prefetch.py``) whose producer thread
reads (and crc-checks) the next chunks and copies them into pinned host
memory, while the caller's thread uploads one and runs its kernels:

  1. grad/hess amax (the scales need the global max first);
  2. level 0: grad/hess from the carry, quantized, stored, and the root's
     sums;
  3. levels 1..D-1: the previous level's routing (its split tables stay
     on the card), the node ids stored, the level's sums (only each
     split's smaller child with histogram subtraction on,
     ``trainer.resolve_subtract``);
  4. the carry: the tree's shrunk leaf values added to each chunk's raw
     scores.

The per-row state lives in ``ChunkStore``s under ``work_dir`` (carry,
quantized grad and hess, node ids), as in the reference; only the split
tables and the accumulators stay on the card. Resumability composes at
the estimator: a checkpointed fit re-enters ``trainer.train`` per segment
with fresh ``init_raw``, and the dispatch streams each segment.

Unsupported configs (sampling, validation sets, multiclass, categorical
or monotone splits, DART, leaf-wise growth) raise here and are screened
by ``trainer._ooc_supported`` before ``train`` streams. The tree loop
runs under ``resilience.fit_watchdog("gbdt.train_ooc")`` (off unless
``MMLSPARK_TORCH_WATCHDOG_MULT`` > 0); a prefetcher's queue wait is its
``input_wait`` boundary. The sanitizer (``core/sanitizer.py``; no-ops
while ``MMLSPARK_TORCH_SAN`` is off) guards the reference's three
boundaries: the base score (``gbdt.ooc.entry``), each level's
histogram, siblings derived (``gbdt.ooc.level_hist``; the merged sums'
dequantization already passed ``gbdt.level_hist``), and each tree's
shrunk leaf values before the carry pass (``gbdt.ooc.carry``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core import sanitizer
from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.core.logging_utils import warn_once
from mmlspark_tpu_torch.core.timer import InstrumentationMeasures
from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod
from mmlspark_tpu_torch.models.gbdt import trainer as T
from mmlspark_tpu_torch.ops.ingest import (ChunkStore, SpillCorrupt,
                                           SpillReader, SpillWriter,
                                           binned_ingest_dtype)
from mmlspark_tpu_torch.parallel import resilience
from mmlspark_tpu_torch.parallel.prefetch import BatchPrefetcher

__all__ = ["train_from_binned", "train_ooc"]


def _numpy(rows) -> np.ndarray:
    """Rows of bin ids as numpy: a tensor (on any device) comes to the
    host; uint16 through int16's bits (torch converts little to or from
    uint16), uint8 and int32 as they are."""
    if not isinstance(rows, torch.Tensor):
        return np.asarray(rows)
    if rows.dtype == torch.uint16:
        return rows.view(torch.int16).cpu().numpy().view(np.uint16)
    return rows.cpu().numpy()


def _host_tensor(arr: np.ndarray, pin: bool):
    """A chunk's array as a host tensor of its own (chunks read from disk
    are read-only views), in pinned memory where it goes to the card, so
    its upload runs asynchronously: (tensor, whether it holds uint16 ids
    as int16's bits)."""
    a = np.ascontiguousarray(arr)
    wide = a.dtype == np.uint16
    if wide:
        a = a.view(np.int16)
    if not pin:
        return torch.from_numpy(a.copy()), wide
    t = torch.empty(a.shape, pin_memory=True,
                    dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
    t.numpy()[...] = a
    return t, wide


def _upload(staged, dev: torch.device) -> torch.Tensor:
    """A staged chunk on ``dev``, on the current stream (asynchronous
    from pinned memory); uint16 ids viewed back from int16's bits."""
    t, wide = staged
    t = t.to(dev, non_blocking=True)
    return t.view(torch.uint16) if wide else t


def _chunk_getter(obj, offsets: List[int], rows: List[int]
                  ) -> Optional[Callable[[int], np.ndarray]]:
    """Per-chunk float32 accessor over an in-memory array or a per-chunk
    store (anything with ``.get(i)``, e.g. ``ChunkStore``); None stays
    None."""
    if obj is None:
        return None
    if hasattr(obj, "get"):
        return lambda i: np.asarray(obj.get(i), dtype=np.float32)
    arr = np.asarray(obj, dtype=np.float32)

    def get(i: int) -> np.ndarray:
        return arr[offsets[i]:offsets[i] + rows[i]]
    return get


def train_from_binned(binned, labels: np.ndarray, cfg: T.TrainConfig,
                      weights: Optional[np.ndarray] = None,
                      bin_upper: Optional[np.ndarray] = None,
                      init_model=None,
                      init_raw: Optional[np.ndarray] = None,
                      callbacks=None, measures=None,
                      iteration_offset: int = 0,
                      device: DeviceLike = None) -> T.TrainResult:
    """Stream an (N, F) binned matrix (numpy, or a tensor on any device)
    through the out-of-core loop: spill it to a temporary directory in
    ``trainer.OOC_CHUNK_ROWS`` chunks and run :func:`train_ooc`,
    which can re-derive a chunk that fails its checksum from the matrix.
    ``trainer.train``'s out-of-core target. Ids outside [0, max_bin)
    raise ``ValueError``, as in-core. For fits whose rows never exist as
    one array, write the spill with ``SpillWriter`` and call
    :func:`train_ooc`."""
    measures = measures if measures is not None else InstrumentationMeasures()
    chunk_rows = T.OOC_CHUNK_ROWS
    n = binned.shape[0]
    tmp = tempfile.mkdtemp(prefix="mmlspark-torch-ooc-")

    def source(i: int) -> np.ndarray:
        return _numpy(binned[i * chunk_rows:(i + 1) * chunk_rows])

    try:
        with measures.phase("dataPreparation"):
            writer = SpillWriter(os.path.join(tmp, "binned"),
                                 dtype=binned_ingest_dtype(cfg.max_bin))
            for i in range(-(-n // chunk_rows)):
                rows = source(i)
                if len(rows) and (int(rows.min()) < 0
                                  or int(rows.max()) >= cfg.max_bin):
                    raise ValueError(
                        f"bin ids must lie in [0, max_bin={cfg.max_bin})")
                writer.append(rows)
            spill = writer.finalize()
        return train_ooc(spill, labels, cfg, weights=weights,
                         bin_upper=bin_upper, init_model=init_model,
                         init_raw=init_raw, callbacks=callbacks,
                         measures=measures,
                         iteration_offset=iteration_offset,
                         work_dir=os.path.join(tmp, "state"),
                         source=source, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_ooc(spill: SpillReader, labels, cfg: T.TrainConfig, *,
              weights=None, bin_upper: Optional[np.ndarray] = None,
              init_model=None, init_raw=None, callbacks=None,
              measures=None, iteration_offset: int = 0,
              work_dir: Optional[str] = None,
              source: Optional[Callable[[int], np.ndarray]] = None,
              device: DeviceLike = None) -> T.TrainResult:
    """Chunked boosting over a sealed spill directory (see the module
    note). ``device=None`` runs on the card (and raises without one),
    ``device="cpu"`` the plain versions on the CPU.

    ``labels`` / ``weights`` / ``init_raw`` are full (N,) arrays or
    per-chunk stores (``.get(i)`` with the spill's chunking, e.g. a
    ``ChunkStore`` filled while writing the spill), so a fit larger than
    memory never makes a full-N array. The base score is ``train``'s:
    ``init_model``'s (with its ``init_raw``), 0 under ``init_raw`` alone,
    else the objective's from the labels, streamed as a weighted mean
    over chunk stores (a median objective then raises: it needs full
    labels). ``work_dir`` holds the per-chunk carry, quantized grad/hess
    and node ids (a temporary directory removed on exit by default).

    ``source``, where given, maps a chunk index back to its binned rows:
    a spill chunk failing its crc32 is then re-derived and rewritten
    (binning is deterministic on fixed edges, so the trees are
    unchanged) instead of raising; without it the attributed
    ``SpillCorrupt`` propagates, naming the chunk.

    ``callbacks``: ``fn(t, {"iteration": t})`` after each tree.
    ``hist_stats`` holds the reference's keys (``ooc`` True, chunking,
    ``hist_subtract``, the spill's verification mode, seconds, chunks
    and repairs) and the in-core fit's ``subtract``; ``step_stats["ooc"]`` the loop's host seconds: chunk
    reads with their crc (``read_s``) and copies into pinned memory
    (``stage_s``) on the prefetch thread, and on the caller's thread the
    waits for a chunk (``wait_s``) and the device-to-store writes
    (``store_s``), with the sums entry's launches (``sums_calls``)."""
    dev = resolve_device(device)
    measures = measures if measures is not None else InstrumentationMeasures()
    f = spill.n_features
    b = cfg.max_bin
    k = cfg.num_trees_per_iteration
    reason = T._ooc_supported(cfg, k=k)
    if reason is not None:
        raise ValueError(
            f"out-of-core training cannot stream this fit: {reason}")
    T.check_supported(cfg)

    quant = T.resolve_hist_quant()
    if quant == "off":
        # float32 sums do not merge exactly across row chunks; the
        # quantized plane's integer sums do: promote rather than grow
        # trees that depend on the chunking
        quant = "q16"
        warn_once(
            "gbdt.ooc.quant",
            "out-of-core training quantizes histograms (q16): exact "
            "chunk merges need integer accumulation — set "
            "MMLSPARK_TORCH_HIST_QUANT to pick the plane explicitly")
    subtract = T.resolve_subtract()
    qdt = torch.int8 if quant == "q8" else torch.int16
    qmax = 120.0 if quant == "q8" else 32000.0
    ids = binned_ingest_dtype(b)
    pin = dev.type == "cuda"

    depth = cfg.effective_depth
    num_slots = 2 ** (depth + 1) - 1
    nl = cfg.num_leaves if cfg.num_leaves > 0 else 2 ** depth
    split_kw = dict(b=b, lam1=cfg.lambda_l1, lam2=cfg.lambda_l2,
                    min_child=float(cfg.min_data_in_leaf),
                    min_hess=cfg.min_sum_hessian_in_leaf,
                    min_gain=cfg.min_gain_to_split,
                    path_smooth=cfg.path_smooth,
                    max_delta_step=cfg.max_delta_step)
    objective_fn = obj_mod.get_objective(cfg.objective)
    okw = T._objective_kwargs(cfg)
    # the learning rate as the step's float32 device scalar
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=dev)

    offsets, rows = spill.offsets, spill.chunk_rows
    nc = spill.num_chunks
    get_labels = _chunk_getter(labels, offsets, rows)
    if get_labels is None:
        raise ValueError("train_ooc needs labels (array or chunk store)")
    get_weights = _chunk_getter(weights, offsets, rows)
    get_init_raw = _chunk_getter(init_raw, offsets, rows)

    # the base score: trainer.train's resolution
    if init_model is not None:
        base_score = init_model.init_score
        if get_init_raw is None:
            raise ValueError("warm start needs init_raw (the init "
                             "model's raw scores on the training rows)")
    elif get_init_raw is not None:
        base_score = 0.0
    elif cfg.boost_from_average:
        if not hasattr(labels, "get"):
            base_score = obj_mod.init_score(cfg.objective, labels, weights)
        elif cfg.objective in obj_mod.MEDIAN_NAMES:
            raise ValueError(
                f"objective {cfg.objective!r} boosts from the label "
                "median, which needs full labels: pass labels as an "
                "array, or init_raw / boost_from_average=False")
        else:
            # a streaming weighted mean: the objectives' init scores
            # depend on the labels only through it
            tot = wtot = 0.0
            for i in range(nc):
                y = np.asarray(get_labels(i), dtype=np.float64)
                w = (np.ones_like(y) if get_weights is None
                     else np.asarray(get_weights(i), dtype=np.float64))
                tot += float(np.sum(y * w))
                wtot += float(np.sum(w))
            mean = tot / max(wtot, 1e-300)
            base_score = obj_mod.init_score(cfg.objective,
                                            np.asarray([mean]),
                                            np.asarray([1.0]))
        base_score = float(base_score)
    else:
        base_score = 0.0

    own_work = work_dir is None
    if own_work:
        work_dir = tempfile.mkdtemp(prefix="mmlspark-torch-ooc-state-")
    carry_st = ChunkStore(work_dir, "carry")
    gq_st = ChunkStore(work_dir, "gq")
    hq_st = ChunkStore(work_dir, "hq")
    node_st = ChunkStore(work_dir, "node")
    timers = {"read_s": 0.0, "stage_s": 0.0, "wait_s": 0.0, "store_s": 0.0,
              "sums_calls": 0}

    def read_binned(i):
        """The spill read, repaired where ``source`` is given: a chunk
        failing its checksum is re-derived from it (on the prefetch
        thread, like any other read)."""
        try:
            arr = spill.read(i)
        except SpillCorrupt as e:
            if source is None:
                raise
            warn_once(
                "gbdt.ooc.spill_repair",
                "spill chunk %s failed verification (%s); re-deriving it "
                "from the source chunk iterator — repairs are bitwise, "
                "the fit continues", i, e)
            spill.repair(i, source(i))
            arr = spill.read(i)
        return arr.astype(ids, copy=False)

    def sweep(*loaders):
        """(i, *chunk tensors on the device) over the spill's chunks: read
        and staged in host memory on the prefetch thread, uploaded here."""
        def gen():
            for i in range(nc):
                t0 = time.perf_counter()
                arrays = [ld(i) for ld in loaders]
                t1 = time.perf_counter()
                staged = [_host_tensor(a, pin) for a in arrays]
                timers["read_s"] += t1 - t0
                timers["stage_s"] += time.perf_counter() - t1
                yield i, staged

        with BatchPrefetcher(gen(), label="ooc-chunks") as pf:
            while True:
                t0 = time.perf_counter()
                item = next(pf, None)
                timers["wait_s"] += time.perf_counter() - t0
                if item is None:
                    return
                i, staged = item
                yield (i, *[_upload(t, dev) for t in staged])

    def store(st, i, t):
        t0 = time.perf_counter()
        st.put(i, t.cpu().numpy())
        timers["store_s"] += time.perf_counter() - t0

    loaders = [get_labels] + ([get_weights] if get_weights is not None
                              else [])

    def grad_hess(carry, y, *w):
        return objective_fn(carry, y, w[0] if w else None, **okw)

    sanitizer.check_finite("gbdt.ooc.entry", np.float32(base_score))
    with measures.phase("dataPreparation"):
        for i in range(nc):
            if get_init_raw is not None:
                carry_st.put(i, get_init_raw(i).reshape(rows[i]))
            else:
                carry_st.put(i, np.full(rows[i], base_score, np.float32))

    trees: List[tuple] = []

    def boost_one_tree():
        # -- pass 1: the global grad/hess amax, then the pow2 scales ----
        gmax = torch.zeros((), dtype=torch.float32, device=dev)
        hmax = torch.zeros((), dtype=torch.float32, device=dev)
        for _, carry, *yw in sweep(carry_st.get, *loaders):
            g, h = grad_hess(carry, *yw)
            gmax = torch.maximum(gmax, torch.max(torch.abs(g)))
            hmax = torch.maximum(hmax, torch.max(torch.abs(h)))
        gscale, gscale_inv = T._pow2_scale(gmax, qmax)
        hscale, hscale_inv = T._pow2_scale(hmax, qmax)

        tree = (torch.full((num_slots,), -1, dtype=torch.int32, device=dev),
                torch.zeros(num_slots, dtype=torch.int32, device=dev),
                torch.zeros(num_slots, dtype=torch.float32, device=dev),
                torch.zeros(num_slots, dtype=torch.float32, device=dev))
        node_value = tree[2]
        remaining = torch.full((), nl - 1, dtype=torch.int64, device=dev)
        route = []
        prev_hist = prev_split = prev_ss = None
        for d in range(depth):
            level_start, width = 2 ** d - 1, 2 ** d
            acc = torch.zeros((width, f, b, 3), dtype=torch.int64,
                              device=dev)
            # -- the chunk pass: route level d-1, sum level d -----------
            if d == 0:
                for i, bn, carry, *yw in sweep(read_binned, carry_st.get,
                                               *loaders):
                    g, h = grad_hess(carry, *yw)
                    # torch.round rounds half to even, as jnp.rint
                    gq = torch.round(g * gscale).to(qdt)
                    hq = torch.round(h * hscale).to(qdt)
                    gh = torch.stack([gq, hq]).cpu().numpy()
                    t0 = time.perf_counter()
                    gq_st.put(i, gh[0])
                    hq_st.put(i, gh[1])
                    timers["store_s"] += time.perf_counter() - t0
                    H.level_histogram_quant_sums(
                        bn, gq, hq, torch.ones(rows[i], device=dev),
                        torch.zeros(rows[i], dtype=torch.int64, device=dev),
                        1, f, b, acc)
                    timers["sums_calls"] += 1
            else:
                node_ld = (node_st.get if d > 1 else
                           (lambda i: np.zeros(rows[i], np.int32)))
                for i, bn, node, gq, hq in sweep(read_binned, node_ld,
                                                 gq_st.get, hq_st.get):
                    node = node.long()
                    node = T._route_rows(node, d - 1,
                                         T._level_rows(node, d - 1)[0], bn,
                                         *route[d - 1])
                    store(node_st, i, node.to(torch.int32))
                    local, live = T._level_rows(node, d)
                    if subtract:
                        live = live & T._smaller_child(local, prev_ss)
                    H.level_histogram_quant_sums(
                        bn, gq, hq, live.to(torch.float32), local, width, f,
                        b, acc)
                    timers["sums_calls"] += 1
            # -- once per level: build_tree's calls on the merged sums ---
            hist = H.dequantize_sums(acc, gscale_inv, hscale_inv)
            if subtract and d > 0:
                hist = T._derive_sibling_hist(hist, prev_hist, prev_split,
                                              prev_ss)
            sanitizer.check_finite("gbdt.ooc.level_hist", hist)
            if d == 0:
                node_value[0], tree[3][0] = T._root_stats(hist, cfg)
            (do_split, best_feat, best_bin, lval, rval, left_stats,
             right_stats, remaining, small_side) = T._find_numeric_splits(
                hist, None, remaining,
                node_value[level_start:2 * level_start + 1], **split_kw)
            if subtract:
                prev_hist, prev_split, prev_ss = hist, do_split, small_side
            T._record_level(tree, d, do_split, best_feat, best_bin, lval,
                            rval, left_stats, right_stats)
            route.append((best_feat, best_bin, do_split))

        # -- the carry pass: Step.add_trees's shrink, predict, add ------
        nv = sanitizer.check_finite("gbdt.ooc.carry", node_value * lr)
        for i, bn, carry in sweep(read_binned, carry_st.get):
            carry.add_(T._predict_tree(tree[0], tree[1], nv, bn, depth))
            store(carry_st, i, carry)
        trees.append((tree[0], tree[1], nv, tree[3]))

    try:
        with resilience.fit_watchdog("gbdt.train_ooc"):
            for t in range(cfg.num_iterations):
                resilience.step_start(t + iteration_offset)
                fault_point("gbdt.train_step")
                with measures.phase("training"):
                    boost_one_tree()
                for cb in callbacks or ():
                    cb(t, {"iteration": t})
                resilience.step_end()
    finally:
        if own_work:
            shutil.rmtree(work_dir, ignore_errors=True)

    with measures.phase("validation"):
        # one transfer of every tree
        sf, tb, nv, cnt = (
            torch.stack([tr[j] for tr in trees]).cpu().numpy() if trees
            else np.zeros((0, num_slots), dt)
            for j, dt in enumerate((np.int32, np.int32, np.float32,
                                    np.float32)))
    booster = T._assemble_booster(sf, tb, nv, cnt, cfg, f, b, depth,
                                  bin_upper, base_score, -1, init_model)
    stores = (carry_st, gq_st, hq_st, node_st)
    hist_stats: Dict[str, object] = {
        "grow_policy": "depthwise", "hist_quant": quant,
        "hist_shard": "off", "grad_shard": "off",
        "efb_bundles": 0, "efb_bundled_features": 0,
        "ooc": True, "ooc_reason": None,
        "chunk_rows": max(rows) if rows else 0,
        "n_chunks": nc, "subtract": subtract, "hist_subtract": subtract,
        "spill_verify": spill.verify_mode,
        "spill_verify_s": round(
            spill.verify_s + sum(st.verify_s for st in stores), 6),
        "spill_verify_chunks": int(
            spill.verify_chunks + sum(st.verify_chunks for st in stores)),
        "spill_repairs": int(spill.repairs)}
    return T.TrainResult(booster=booster, evals=[], best_iteration=-1,
                         hist_stats=hist_stats,
                         step_stats={"captured": False, "capture_s": None,
                                     "ooc": timers})

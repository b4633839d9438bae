"""Tree-ensemble scoring: the wrapper of the CUDA kernel
``csrc/tree_score.cu``, its launch plan and its plain PyTorch version.

``tree_score(x, tables)`` is the port of the JAX package's jitted
scorers, ``BoosterArrays.predict_binned_fn`` (bin ids against
``threshold_bin``) and ``predict_fn`` (raw float32 features against the
float32 rounding of ``threshold_value``, NaN left): (N, F) rows -> (N,)
or (N, K) float32 raw scores, every tree walked from its root, tree t's
``leaf * weight`` added to class ``t % K`` in tree order from
``init_score``, each add rounded once as XLA's fused multiply-add
(``_add_tree``, ROADMAP C9). Routing is integer (or exact float) work and
the adds a fixed sequence, so the kernel and the plain version return the
same bits.

The tables are packed once per scorer (``pack_nodes``, ``make_tables``):
a 32-bit word per node for bin ids (8 bytes, the wide node, where a
threshold passes 65,534 or a feature 32,767), 8 bytes per node for raw
rows, every leaf above the last level pushed down its left spine so
that each walk takes ``max_depth`` steps, and each slot's float64
product leaf * weight.
``score_plan`` picks the kernel's launch plan from the shapes: ``"rows"``
(persistent CTAs, a thread per row) for large batches, ``"cluster"`` (a
thread-block cluster that splits the trees) for small ones.

The decision route scores raw float32 rows against nodes that carry
LightGBM's decision bits (``pack_decision_nodes``): the routing of the
JAX package's ``BoosterArrays._go_left_fn`` (default-left and missing-type
bits, category bitsets; ``decision_left`` is its plain form), and on
request the leaf slot of every row in every tree, the JAX package's
``leaf_index_fn``, from the same walk in the same launch.

On a CUDA tensor ``tree_score`` launches the kernel, one launch per call
(a build or launch failure raises); on a CPU tensor it runs the plain
version, ``tree_score_reference``. There is no other route. The kernel's
design and bound are in the note at the top of its source.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.native import bindings

# Launches of the kernel in this process, so a run can show that its main
# path went through it; and the same launches by plan.
tree_score_launches = 0
tree_score_plan_launches = {"rows": 0, "cluster": 0}
# ... and by route: bin ids, bin ids against wide nodes, raw rows, raw
# rows under decision bits
tree_score_route_launches = {"bin": 0, "wide": 0, "raw": 0, "decision": 0}

BIN_CODES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
RAW_CODE = 5                 # raw float32 features
DECISION_CODE = 6            # raw float32 features under decision bits
WIDE_CODE = 8                # added to a bin code: ids against wide nodes
LEAF_DTYPES = (torch.float32, torch.bfloat16)  # the plain version's leaves
PLAIN_ROWS = 1 << 16         # rows the plain version routes at once

# What a packed bin node holds: the split feature as int16 and
# threshold_bin as uint16, 65535 being the always-left threshold. Past
# either, a booster's bin nodes are wide: {int32 feature, int32
# threshold}, the always-left threshold int32's largest (every int32 id
# is at most it).
MAX_BIN_FEATURE = 32767
MAX_BIN_THRESHOLD = 65534
ALWAYS_LEFT_BIN = 65535
ALWAYS_LEFT_WIDE = 2 ** 31 - 1
# A packed decision node holds the feature in 16 bits.
MAX_DECISION_FEATURE = 65535

# The launch plans' limits on Hopper (H100): shared memory of a CTA (the
# opt-in maximum) and of an SM, of which the card keeps 1 KB per CTA;
# threads of a CTA; CTAs of a portable cluster.
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
ROW_THREADS = 256            # rows plan: rows of a tile, a thread per row
SM_THREADS = 1024            # the rows kernel's threads per SM (at most 64
                             # registers a thread: __launch_bounds__(1024,
                             # 1)), and the rows of its largest tile
CLUSTER_MAX = 8
CLUSTER_BLOCK_ROWS = 64      # rows of a cluster's block
# The cluster plan takes batches of at most CLUSTER_ROWS_PER_TREE * (T -
# CLUSTER_TREES) rows, the crossovers measured on the card (PERF.md
# section 6, phase kernel_score of chip_smoke.py): at 20 and 40 trees the
# rows plan is as fast or faster at every batch size; at 100 trees the
# cluster plan is faster up to 4,096 rows and slower from 8,192.
CLUSTER_TREES = 40
CLUSTER_ROWS_PER_TREE = 70
SMS = 132                    # SMs of an H100 SXM, when no card is asked


@dataclass(frozen=True)
class TreeTables:
    """A booster's packed tables on one device, tree after tree in the
    full binary layout (node i's children 2i+1 / 2i+2), ``M`` slots per
    tree, every leaf on the last level (``pack_nodes``)."""

    nodes: torch.Tensor           # bin ids: (T * M,) int32 words, or
                                  # (T * M, 2) int32 wide nodes; raw
                                  # rows: (T * M, 2) int32 (pack_nodes)
    leaf: torch.Tensor            # (T * M,) float32 or bfloat16
    tree_weight: torch.Tensor     # (T,) float32
    products: torch.Tensor        # (T * M,) float64 leaf * weight
    num_nodes: int                # M = 2^(max_depth+1) - 1
    max_depth: int
    num_class: int
    num_features: int             # every split feature is below it
    init_score: float
    # the decision route (pack_decision_nodes): the categorical nodes'
    # bitsets ((C * bit_words,) int32 holding uint32 words) and each
    # slot's leaf slot ((T * M,) int32)
    bits: Optional[torch.Tensor] = None
    bit_words: int = 0
    leaf_slot: Optional[torch.Tensor] = None
    # bin nodes of two int32 words (feature, threshold), compared with
    # the ids unclamped
    wide: bool = False

    @property
    def raw(self) -> bool:
        """Raw float32 features (``predict``) rather than bin ids."""
        return self.nodes.dim() == 2 and not self.wide

    @property
    def decision(self) -> bool:
        """Raw rows routed by decision bits (``pack_decision_nodes``)."""
        return self.leaf_slot is not None

    @property
    def route(self) -> str:
        return ("decision" if self.decision else "raw" if self.raw
                else "wide" if self.wide else "bin")

    @property
    def num_trees(self) -> int:
        return self.tree_weight.shape[0]


def pack_nodes(split_feature: np.ndarray, threshold: np.ndarray,
               node_value: np.ndarray, max_depth: int, raw: bool):
    """The kernel's node table and leaf values from (T, M) split features
    (< 0 at a leaf), thresholds and node values. A leaf above level
    ``max_depth`` is pushed down its left spine: its slot and the spine's
    slots above the last level become always-left nodes (feature 0,
    threshold 65535 for bin ids, int32's largest for wide bin nodes, +inf
    for raw rows, where NaN goes left too) and the spine's slot on the
    last level takes its value, so a walk of ``max_depth`` steps ends on
    the leaf's value wherever the leaf was. Bin ids (``raw`` False, int
    thresholds) pack into one int32 word per node, the feature as int16
    in the low half and ``threshold_bin`` as uint16 in the high half,
    while every split feature is at most 32767 and every threshold at
    most 65534; past either, into wide nodes, a (T * M, 2) int32 array of
    the feature and the threshold. Raw rows (float thresholds, rounded to
    float32) pack into a (T * M, 2) int32 array of the feature and the
    float32 threshold's bits. Returns (nodes, float32 leaf values
    (T * M,), whether the nodes are wide bin nodes). Raises ``ValueError`` for a negative bin threshold, which
    no bin node holds (binned scoring refuses such boosters before,
    ``BoosterArrays.supports_binned``)."""
    sf = np.array(split_feature, np.int64)
    nv = np.array(node_value, np.float32)
    thr = np.array(threshold, np.float32 if raw else np.int64)
    internal = sf >= 0
    wide = False
    if not raw and internal.any():
        lo, hi = int(thr[internal].min()), int(thr[internal].max())
        if lo < 0 or hi >= ALWAYS_LEFT_WIDE:
            raise ValueError(f"bin thresholds {lo}..{hi} leave "
                             f"0..{ALWAYS_LEFT_WIDE - 1}: no packed bin "
                             f"node holds them")
        wide = (int(sf[internal].max()) > MAX_BIN_FEATURE
                or hi > MAX_BIN_THRESHOLD)
    pushed, _ = _push_leaves_down(sf, nv, max_depth)
    thr[pushed] = np.inf if raw else (ALWAYS_LEFT_WIDE if wide
                                      else ALWAYS_LEFT_BIN)
    sf, thr, nv = sf.reshape(-1), thr.reshape(-1), nv.reshape(-1)
    if raw or wide:
        nodes = np.empty((sf.size, 2), np.int32)
        nodes[:, 0] = sf
        nodes[:, 1] = thr.view(np.int32) if raw else np.where(sf >= 0, thr,
                                                              0)
        return nodes, nv, wide
    word = (np.where(sf >= 0, thr, 0) << 16) | (sf & 0xFFFF)
    return word.astype(np.uint32).view(np.int32), nv, False


def _push_leaves_down(sf: np.ndarray, nv: np.ndarray, max_depth: int):
    """In place on (T, M) int64 split features and float32 node values:
    every leaf above level ``max_depth`` goes down its left spine (its
    slot and the spine's slots above the last level become nodes of
    feature 0, the spine's last slot takes its value). Returns the (T, M)
    bool mask of the slots that became such nodes (the caller gives them
    an always-left threshold) and the (T, M) int64 leaf slot each slot
    stands for: itself, or on a spine the leaf pushed down it."""
    origin = np.broadcast_to(np.arange(sf.shape[1]), sf.shape).copy()
    pushed = np.zeros(sf.shape, bool)
    sf[sf < 0] = -1
    for level in range(max_depth):
        first = 2 ** level - 1
        t, j = np.nonzero(sf[:, first:2 * first + 1] < 0)
        node = first + j
        sf[t, node] = 0
        pushed[t, node] = True
        sf[t, 2 * node + 1] = -1
        nv[t, 2 * node + 1] = nv[t, node]
        origin[t, 2 * node + 1] = origin[t, node]
    return pushed, origin


def pack_decision_nodes(split_feature: np.ndarray,
                        threshold_value: np.ndarray, node_value: np.ndarray,
                        max_depth: int, decision_type: np.ndarray,
                        cat_bitset: Optional[np.ndarray]):
    """The decision route's tables from (T, M) split features, raw
    thresholds, node values and LightGBM ``decision_type`` bits, and the
    (T, M, W) uint32 category bitsets (None where no node is
    categorical). Leaves are pushed down as ``pack_nodes`` does, behind
    nodes of decision byte 0 and threshold +inf, which every value
    passes. A node is two int32 words: the feature in the low 16 bits and
    the decision byte above them, then the float32 threshold's bits or,
    at a categorical node (bit 0), the word offset of its bitset in
    ``bits``. Returns (nodes (T * M, 2) int32, float32 leaf values
    (T * M,), bits (C * W,) int32 holding the C categorical nodes'
    bitsets (one zero word where there are none), W, leaf slots (T * M,)
    int32: the leaf slot each last-level slot stands for). Raises
    ``ValueError`` for a split feature above 65535."""
    sf = np.array(split_feature, np.int64)
    nv = np.array(node_value, np.float32)
    thr = np.array(threshold_value, np.float32)
    dt = np.array(decision_type, np.int64) & 0xFF
    internal = sf >= 0
    if internal.any() and int(sf[internal].max()) > MAX_DECISION_FEATURE:
        raise ValueError(f"a split feature ({int(sf[internal].max())}) is "
                         f"above {MAX_DECISION_FEATURE}: a packed decision "
                         f"node holds the feature in 16 bits")
    cat = internal & ((dt & 1) == 1)
    words = 1
    bits = np.zeros(1, np.uint32)
    offset = np.zeros(sf.shape, np.int64)
    if cat.any():
        words = int(cat_bitset.shape[2])
        bits = np.asarray(cat_bitset, np.uint32)[cat].reshape(-1)
        offset[cat] = np.arange(int(cat.sum())) * words
    pushed, origin = _push_leaves_down(sf, nv, max_depth)
    dt[pushed | (sf < 0)] = 0
    thr[pushed] = np.inf
    nodes = np.empty(sf.shape + (2,), np.int32)
    nodes[..., 0] = np.where(sf >= 0, sf | (dt << 16), -1)
    nodes[..., 1] = np.where(cat, offset, thr.view(np.int32))
    return (nodes.reshape(-1, 2), nv.reshape(-1), bits.view(np.int32), words,
            origin.reshape(-1).astype(np.int32))


def make_tables(nodes: torch.Tensor, leaf: torch.Tensor,
                tree_weight: torch.Tensor, num_nodes: int, max_depth: int,
                num_class: int, num_features: int,
                init_score: float, wide: bool = False,
                **decision) -> TreeTables:
    """``TreeTables`` of packed nodes, leaf values and tree weights on one
    device, with each slot's product leaf * weight (a bfloat16 leaf
    promoted to float32 first; exact in float64). ``wide``: ``nodes``
    are wide bin nodes (``pack_nodes``). ``decision``: the decision
    route's ``bits``, ``bit_words`` and ``leaf_slot``."""
    products = leaf.float().double() * tree_weight.double() \
        .repeat_interleave(num_nodes)
    return TreeTables(nodes=nodes, leaf=leaf, tree_weight=tree_weight,
                      products=products, num_nodes=num_nodes,
                      max_depth=max_depth, num_class=num_class,
                      num_features=num_features, init_score=init_score,
                      wide=wide, **decision)


@dataclass(frozen=True)
class ScorePlan:
    """How the kernel covers one call: ``regime`` ``"rows"`` (persistent
    CTAs of ``rows`` threads, a thread per row, ``ctas`` CTAs looping over
    tiles of ``rows`` rows, the trees in chunks of ``chunk``) or
    ``"cluster"`` (``ctas / cluster`` clusters of ``cluster`` CTAs, each
    cluster a block of ``rows`` rows, rank r walking its ``<= chunk``
    trees); ``smem`` dynamic shared-memory bytes per CTA; ``tables``
    ``"shared"`` (tables and rows staged in shared memory) or
    ``"global"`` (read where they lie)."""

    regime: str
    rows: int
    ctas: int
    cluster: int
    chunk: int
    smem: int
    tables: str

    @property
    def args(self) -> tuple:
        """The plan as the C entry points take it."""
        return (0 if self.regime == "rows" else 1, self.rows, self.ctas,
                self.cluster, self.chunk, self.smem,
                int(self.tables == "shared"))


def _align(v: int, a: int) -> int:
    return (v + a - 1) // a * a


def _row_words(features: int, in_bytes: int) -> int:
    """32-bit words of a staged row, the last one partly used."""
    return (features * in_bytes + 3) // 4


def _smem_bytes(chunk: int, m: int, raw: bool, features: int, words: int,
                cluster: bool, rows: int = CLUSTER_BLOCK_ROWS,
                wide_ids: int = 0) -> int:
    """The kernel's shared-memory layout (``Layout`` in the source): the
    nodes (8 bytes each for raw rows and wide bin nodes, else 4) and the
    float64 products of ``chunk`` trees, the cluster's float64 products
    of its walks, a 32-bit value per feature of each of the ``rows`` rows
    of a tile (a cluster's block), and for the rows plan's rows that are
    not staged as they lie the next rows' ``words`` raw words: bin ids,
    but for int32 ids against wide nodes. ``wide_ids``: the bytes of an
    id scored against wide nodes (0: narrow nodes or raw rows)."""
    cells = chunk * m
    end = _align(cells * (8 if raw or wide_ids else 4), 8) + cells * 8
    if cluster:
        end += chunk * rows * 8
    values = _align(end, 16) + features * rows * 4
    direct = raw or wide_ids == 4
    return values if cluster or direct else values + rows * 4 * words


def _shape(in_dtype: torch.dtype, wide: bool = False):
    """(bytes of an input element, raw rows?, bytes of an id against wide
    nodes or 0)."""
    in_bytes = torch.empty((), dtype=in_dtype).element_size()
    raw = in_dtype == torch.float32
    return in_bytes, raw, in_bytes if wide and not raw else 0


def rows_plan(n: int, trees: int, nodes: int, k: int, in_dtype: torch.dtype,
              features: int, sms: int = SMS,
              wide: bool = False) -> ScorePlan:
    """The rows plan. Where the batch fills every SM with tiles of 1,024
    rows and one CTA of them holds every tree, one such CTA per SM (one
    copy of the tables per SM). Else tiles of 256 rows: every tree in one
    chunk if the chunk and the tiles leave room for two CTAs per SM; else
    chunks of as many trees as do; else as fit one CTA per SM; else (a
    tree or a tile larger than a CTA's shared memory) the global route,
    one pass reading the tables and rows where they lie."""
    in_bytes, raw, wide_ids = _shape(in_dtype, wide)
    words = _row_words(features, in_bytes)

    def smem(chunk, rows=ROW_THREADS):
        return _smem_bytes(chunk, nodes, raw, features, words, False, rows,
                           wide_ids)

    if n >= sms * SM_THREADS and smem(max(trees, 1), SM_THREADS) \
            <= SMEM_BLOCK:
        return ScorePlan("rows", SM_THREADS, sms, 1, max(trees, 1),
                         smem(max(trees, 1), SM_THREADS), "shared")

    def most(budget):     # the most trees whose chunk fits ``budget``
        lo, hi = 0, max(trees, 1)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if smem(mid) <= budget else (lo, mid - 1)
        return lo

    chunk = 0
    for budget in (SMEM_SM // 2 - SMEM_RESERVED, SMEM_BLOCK):
        chunk = most(budget)
        if chunk:
            break
    tiles = max(1, -(-n // ROW_THREADS))
    per_sm = SM_THREADS // ROW_THREADS
    if not chunk:
        return ScorePlan("rows", ROW_THREADS, min(tiles, sms * per_sm), 1,
                         max(trees, 1), 0, "global")
    size = smem(chunk)
    per_sm = max(1, min(per_sm, SMEM_SM // (size + SMEM_RESERVED)))
    return ScorePlan("rows", ROW_THREADS, min(tiles, sms * per_sm), 1,
                     chunk, size, "shared")


def cluster_plan(n: int, trees: int, nodes: int, k: int,
                 in_dtype: torch.dtype, features: int,
                 wide: bool = False) -> Optional[ScorePlan]:
    """The cluster plan: ``min(8, T)`` CTAs per cluster, rank r the trees
    ``[r*T/C, (r+1)*T/C)``, a cluster per block of 64 rows; None where a
    rank's tables, products and rows do not fit a CTA's shared
    memory."""
    in_bytes, raw, wide_ids = _shape(in_dtype, wide)
    ranks = max(1, min(CLUSTER_MAX, trees))
    chunk = -(-trees // ranks)
    size = _smem_bytes(chunk, nodes, raw, features,
                       _row_words(features, in_bytes), True,
                       wide_ids=wide_ids)
    if size > SMEM_BLOCK:
        return None
    blocks = max(1, -(-n // CLUSTER_BLOCK_ROWS))
    return ScorePlan("cluster", CLUSTER_BLOCK_ROWS, ranks * blocks, ranks,
                     chunk, size, "shared")


def cluster_rows(trees: int) -> int:
    """The largest batch the cluster plan takes through ``trees`` trees
    (none below ``CLUSTER_TREES``)."""
    return max(0, CLUSTER_ROWS_PER_TREE * (trees - CLUSTER_TREES))


@functools.lru_cache(maxsize=1024)
def score_plan(n: int, trees: int, nodes: int, k: int, in_dtype: torch.dtype,
               features: int, sms: int = SMS,
               wide: bool = False) -> ScorePlan:
    """The kernel's plan for ``n`` rows of ``features`` ``in_dtype``
    values (float32: raw rows) through ``trees`` trees of ``nodes`` slots
    (``wide`` bin nodes or not) and ``k`` classes on a card of ``sms``
    SMs: the cluster plan where it fits and the batch is at most
    ``cluster_rows(trees)`` rows; else the rows plan."""
    if n <= cluster_rows(trees):
        plan = cluster_plan(n, trees, nodes, k, in_dtype, features, wide)
        if plan is not None:
            return plan
    return rows_plan(n, trees, nodes, k, in_dtype, features, sms, wide)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(n: int, features: int, dtype: torch.dtype, tables: TreeTables,
              device: torch.device) -> ScorePlan:
    sms = _sm_count(device.index) if device.type == "cuda" else SMS
    return score_plan(n, tables.num_trees, tables.num_nodes,
                      tables.num_class, dtype, features, sms, tables.wide)


def _check(x: torch.Tensor, tables: TreeTables) -> None:
    t, m = tables.num_trees, tables.num_nodes
    node_shape = (t * m, 2) if tables.raw or tables.wide else (t * m,)
    if tables.leaf.dtype not in LEAF_DTYPES:
        raise ValueError(f"tables: leaves {tables.leaf.dtype}")
    for name, v, dtype, shape in (
            ("nodes", tables.nodes, torch.int32, node_shape),
            ("leaf", tables.leaf, tables.leaf.dtype, (t * m,)),
            ("tree_weight", tables.tree_weight, torch.float32, (t,)),
            ("products", tables.products, torch.float64, (t * m,))) + ((
            ("bits", tables.bits, torch.int32,
             (tables.bits.numel(),) if tables.bits is not None else ()),
            ("leaf_slot", tables.leaf_slot, torch.int32, (t * m,)))
            if tables.decision else ()):
        if v.dtype != dtype or tuple(v.shape) != shape \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"tables.{name} must be a contiguous {dtype} "
                             f"{shape} on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if tables.decision and (tables.bit_words < 1 or tables.bits.numel()
                            % tables.bit_words or not tables.bits.numel()):
        raise ValueError(f"tables.bits: {tables.bits.numel()} words, not "
                         f"whole bitsets of {tables.bit_words}")
    if m < 2 ** (tables.max_depth + 1) - 1:
        raise ValueError(f"{m} nodes per tree do not hold depth "
                         f"{tables.max_depth}")
    want = (torch.float32,) if tables.raw else tuple(BIN_CODES)
    if x.dim() != 2 or x.dtype not in want:
        raise ValueError(f"x must be a 2-d tensor of {want}, got {x.dtype} "
                         f"with shape {tuple(x.shape)}")
    if x.shape[1] < tables.num_features:
        raise ValueError(f"x has {x.shape[1]} features, the trees split on "
                         f"{tables.num_features}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def tree_score(x: torch.Tensor, tables: TreeTables, leaves: bool = False):
    """(N, F) bin ids (uint8 / uint16 / int32, for packed bin nodes, wide
    or not) or raw float32 features (for packed raw or decision nodes),
    contiguous, on the tables' device -> (N,) or (N, K) float32 raw
    scores; with ``leaves`` (decision tables only) also the (N, T) int32
    leaf slot of every row in every tree, from the same walk (on the card
    the transpose of the kernel's tree-major (T, N) output, a view)."""
    _check(x, tables)
    if leaves and not tables.decision:
        raise ValueError("leaf slots come from decision tables "
                         "(pack_decision_nodes)")
    if x.device.type == "cpu":
        return tree_score_reference(x, tables, leaves)
    return _launch(x, tables, leaves=leaves)


def _add_tree(acc: torch.Tensor, contribution: torch.Tensor) -> None:
    """``acc += leaf * weight`` for one tree, in place on a float32 row
    of the accumulator, rounded once: XLA contracts the JAX ``scan``'s
    ``acc.at[:, cls].add(nv * tw)`` into one fused multiply-add on the
    CPU (ROADMAP C9). ``contribution`` is the float64 product of two
    float32 values, so it is exact; the float64 sum then rounds far
    below a float32 ulp, so the one float32 rounding is the fused op's
    (barring a sum exactly on a midpoint), as ``trainer._smooth`` does
    for C5. One elementwise op: the add runs in float64 and writes
    float32."""
    torch.add(acc, contribution, out=acc)


def unpack_nodes(tables: TreeTables):
    """(feature, threshold) per node of the packed tables: int64 features
    (< 0 on the last level, 0 at an always-left node) and thresholds,
    int64 bin thresholds or float32 raw ones (for decision tables the
    feature, the decision byte, the float32 threshold and its bits as
    int64, the bitset offset at a categorical node)."""
    if tables.decision:
        word = tables.nodes[:, 0].long()
        feat = torch.where(word < 0, word, word & 0xFFFF)
        return (feat, (word >> 16) & 0xFF,
                tables.nodes.view(torch.float32)[:, 1],
                tables.nodes[:, 1].long())
    if tables.raw:
        return tables.nodes[:, 0].long(), \
            tables.nodes.view(torch.float32)[:, 1]
    if tables.wide:
        return tables.nodes[:, 0].long(), tables.nodes[:, 1].long()
    word = tables.nodes.long() & 0xFFFFFFFF
    return ((word & 0xFFFF) ^ 0x8000) - 0x8000, word >> 16


def _depth(x: torch.Tensor, tables: TreeTables) -> int:
    """Steps of every walk: ``max_depth``, or none for rows of no
    features (whose trees are single leaves, on their root's slot)."""
    return tables.max_depth if x.shape[1] else 0


def decision_left(fx: torch.Tensor, dt: torch.Tensor, thr: torch.Tensor,
                  category_word=None, limit: int = 0) -> torch.Tensor:
    """Where float32 values ``fx`` go left at nodes of LightGBM decision
    bits ``dt`` (int64) and float32 thresholds ``thr``, all of one shape:
    the JAX package's ``_go_left_fn``. Bit 1 is default-left; bits 2-3
    the missing type: 0 compares NaN as 0.0, 1 treats 0.0 and NaN as
    missing, 2 treats NaN as missing; a missing value goes the default
    way, any other compares ``value <= threshold``. At a categorical node
    (bit 0) the value is truncated toward zero and goes left where its bit
    is set: ``category_word(w)`` gives word ``w`` (int64) of each node's
    bitset (uint32 values, int64), ``limit`` the categories the bitsets
    hold; NaN, negative and out-of-range values go right. None where no
    node is categorical."""
    nan = torch.isnan(fx)
    x0 = torch.where(nan, torch.zeros_like(fx), fx)
    mt = (dt >> 2) & 3
    missing = torch.where(mt == 2, nan, (mt == 1) & (x0 == 0.0))
    left = torch.where(missing, (dt & 2) != 0, x0 <= thr)
    if category_word is None:
        return left
    t = torch.trunc(fx)
    valid = (t >= 0) & (t < limit)      # NaN fails both
    c = torch.where(valid, t, torch.zeros_like(t)).long()
    member = ((category_word(c >> 5) >> (c & 31)) & 1) == 1
    return torch.where((dt & 1) == 1, valid & member, left)


def leaf_nodes(x: torch.Tensor, tables: TreeTables) -> torch.Tensor:
    """(rows, T) int64 last-level slot of every row in every tree: all
    trees routed at once, level by level, on a (rows, trees) node tensor
    indexed at ``t * M + node``. Bin ids compare clamped to 65535 against
    narrow nodes, as the kernel compares them (left of the always-left
    threshold only), and as they are against wide nodes."""
    offsets = (torch.arange(tables.num_trees, device=x.device)
               * tables.num_nodes)[None, :]
    if tables.decision:
        return _decision_leaf_nodes(x, tables, offsets)
    sf, thr = unpack_nodes(tables)
    # gather takes no uint16, and bin ids compare as integers
    xs = x if tables.raw else x.long() if tables.wide \
        else x.long().clamp_max(ALWAYS_LEFT_BIN)
    node = torch.zeros((x.shape[0], tables.num_trees), dtype=torch.int64,
                       device=x.device)
    for _ in range(_depth(x, tables)):
        flat = node + offsets
        fx = torch.gather(xs, 1, sf[flat].clamp_min(0))
        left = (torch.isnan(fx) | (fx <= thr[flat])) if tables.raw \
            else fx <= thr[flat]
        node = 2 * node + torch.where(left, 1, 2)
    return node


def _decision_leaf_nodes(x: torch.Tensor, tables: TreeTables,
                         offsets: torch.Tensor) -> torch.Tensor:
    """``leaf_nodes`` of decision tables (``decision_left`` per step)."""
    sf, dt, thr, word = unpack_nodes(tables)
    bits = tables.bits.long() & 0xFFFFFFFF
    node = torch.zeros((x.shape[0], tables.num_trees), dtype=torch.int64,
                       device=x.device)
    for _ in range(_depth(x, tables)):
        flat = node + offsets
        fx = torch.gather(x, 1, sf[flat].clamp_min(0))
        d = dt[flat]
        # the bitset offset where the node is categorical (else a
        # threshold's bits)
        at = torch.where((d & 1) == 1, word[flat], 0)
        left = decision_left(fx, d, thr[flat], lambda w: bits[at + w],
                             tables.bit_words * 32)
        node = 2 * node + torch.where(left, 1, 2)
    return node


def tree_score_reference(x: torch.Tensor, tables: TreeTables,
                         leaves: bool = False):
    """The plain version: a block of rows' leaves in every tree
    (``leaf_nodes``), then the trees' contributions added one by one in
    tree order (``_add_tree``): the JAX ``scan``'s left fold (a ``sum``
    or ``cumsum`` over the tree axis would add in another order). Rows
    are independent, so blocks of ``PLAIN_ROWS`` change no bit. With
    ``leaves`` (decision tables) also the (N, T) int32 leaf slots."""
    n, k = x.shape[0], tables.num_class
    dev = x.device
    offsets = (torch.arange(tables.num_trees, device=dev)
               * tables.num_nodes)[None, :]
    tw64 = tables.tree_weight.double()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    slots = (torch.empty((n, tables.num_trees), dtype=torch.int32, device=dev)
             if leaves else None)
    for s in range(0, n, PLAIN_ROWS):
        node = leaf_nodes(x[s:s + PLAIN_ROWS], tables)
        if leaves:
            slots[s:s + PLAIN_ROWS] = tables.leaf_slot[node + offsets]
        # (T, rows): each leaf (bf16 promoted to float32 first) times its
        # tree's weight, exact in float64
        val = (tables.leaf[node + offsets].float().double() * tw64).t()
        acc = torch.full((k, node.shape[0]), tables.init_score,
                         dtype=torch.float32, device=dev)
        for t in range(tables.num_trees):
            _add_tree(acc[t % k], val[t])
        out[s:s + PLAIN_ROWS] = acc.t()
    scores = out[:, 0] if k == 1 else out
    return (scores, slots) if leaves else scores


def _x_code(dtype: torch.dtype, tables: TreeTables) -> int:
    """The kernel's code for rows of ``dtype`` against ``tables``: raw
    rows, or bin ids against bin nodes (wide ones past ``WIDE_CODE``)."""
    if tables.raw:
        return RAW_CODE
    return BIN_CODES[dtype] + (WIDE_CODE if tables.wide else 0)


class StagedBatch:
    """The buffers of one padded batch shape of a served model: ``x``, a
    numpy view of the (rows, F) bin ids to score, and ``out``, one of
    their (rows, K) float32 scores, both in host memory (pinned when the
    tables lie on the card), and their twins on the tables' device; and
    the kernel's plan for that shape. ``tree_score_staged`` scores them
    in one call."""

    def __init__(self, tables: TreeTables, rows: int, features: int,
                 dtype: torch.dtype):
        if tables.raw or dtype not in BIN_CODES:
            raise ValueError(f"a staged batch holds bin ids of "
                             f"{tuple(BIN_CODES)} for packed bin nodes, got "
                             f"{dtype} (raw tables: {tables.raw})")
        if features < tables.num_features:
            raise ValueError(f"{features} features, the trees split on "
                             f"{tables.num_features}")
        dev = tables.tree_weight.device
        pin = dev.type == "cuda"
        self.host_in = torch.zeros((rows, features), dtype=dtype,
                                   pin_memory=pin)
        self.host_out = torch.zeros((rows, tables.num_class),
                                    dtype=torch.float32, pin_memory=pin)
        self.dev_in = torch.empty_like(self.host_in, device=dev)
        self.dev_out = torch.empty_like(self.host_out, device=dev)
        self.x = self.host_in.numpy()
        self.out = self.host_out.numpy()
        self.plan = _plan_for(rows, features, dtype, tables, dev)
        # the library's arguments that never change, read once: a torch
        # call on the serving thread can give up the interpreter lock
        self.args = (self.host_in.data_ptr(), self.dev_in.data_ptr(),
                     _x_code(dtype, tables), self.x.nbytes)


def tree_score_staged(batch: StagedBatch, tables: TreeTables) -> None:
    """Score ``batch.x`` into ``batch.out``: on the card one call into the
    library (the copy in, the kernel, the copy out and a wait for the
    stream; one launch), on the CPU the plain version."""
    global tree_score_launches
    if batch.dev_in.device != tables.tree_weight.device:
        raise ValueError(f"the batch lies on {batch.dev_in.device}, the "
                         f"tables on {tables.tree_weight.device}")
    if batch.dev_in.device.type == "cpu":
        batch.host_out.copy_(tree_score_reference(
            batch.host_in, tables).reshape(batch.host_out.shape))
        return
    lib = bindings.load("tree_score")
    dev = batch.dev_in.device
    n, f = batch.x.shape
    code = lib.mmls_tree_score_staged(
        *batch.args, tables.nodes.data_ptr(), tables.products.data_ptr(),
        batch.dev_out.data_ptr(), batch.host_out.data_ptr(),
        ctypes.c_float(tables.init_score), n, f, tables.num_trees,
        tables.num_nodes, tables.max_depth if f else 0, tables.num_class,
        *batch.plan.args, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    bindings.check(lib, code, "tree_score staged batch")
    tree_score_launches += 1
    tree_score_plan_launches[batch.plan.regime] += 1
    tree_score_route_launches[tables.route] += 1


def _launch(x: torch.Tensor, tables: TreeTables,
            plan: Optional[ScorePlan] = None, leaves: bool = False):
    """One launch of the kernel on ``x`` under ``plan`` (default
    ``score_plan``'s for the shapes); with ``leaves`` (decision tables)
    the leaf slots too."""
    global tree_score_launches
    lib = bindings.load("tree_score")
    n, k = x.shape[0], tables.num_class
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    # the kernel writes the slots tree-major; the caller gets the (N, T)
    # transpose, a view
    slots = (torch.empty((tables.num_trees, n), dtype=torch.int32,
                         device=x.device) if leaves else None)
    if n:
        dev = x.device
        if plan is None:
            plan = _plan_for(n, x.shape[1], x.dtype, tables, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tables.decision:
            code = lib.mmls_tree_score_decision(
                x.data_ptr(), tables.nodes.data_ptr(),
                tables.products.data_ptr(), out.data_ptr(),
                ctypes.c_float(tables.init_score), n, x.shape[1],
                tables.num_trees, tables.num_nodes, _depth(x, tables), k,
                tables.bits.data_ptr(), tables.bit_words,
                tables.leaf_slot.data_ptr(),
                slots.data_ptr() if leaves else None, *plan.args,
                dev.index, stream)
        else:
            code = lib.mmls_tree_score(
                x.data_ptr(), _x_code(x.dtype, tables),
                tables.nodes.data_ptr(), tables.products.data_ptr(),
                out.data_ptr(), ctypes.c_float(tables.init_score), n,
                x.shape[1], tables.num_trees, tables.num_nodes,
                _depth(x, tables), k, *plan.args, dev.index, stream)
        bindings.check(lib, code, "tree_score kernel launch")
        tree_score_launches += 1
        tree_score_plan_launches[plan.regime] += 1
        tree_score_route_launches[tables.route] += 1
    scores = out[:, 0] if k == 1 else out
    return (scores, slots.t()) if leaves else scores

"""Tree-ensemble scoring: the wrapper of the CUDA kernel
``csrc/tree_score.cu`` and its plain PyTorch version.

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

On a CUDA tensor ``tree_score`` launches the kernel, one launch per call
(a build or launch failure raises); on a CPU tensor it runs the plain
version, ``tree_score_reference``. There is no other route. The kernel's
design and bound are in the note at the top of its source.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from mmlspark_tpu_torch.native import bindings

# Launches of the kernel in this process, so a run can show that its main
# path went through it.
tree_score_launches = 0

BIN_CODES = {torch.uint8: 1, torch.uint16: 2, torch.int32: 4}
RAW_CODE = 5                 # raw float32 features
LEAF_CODES = {torch.float32: 0, torch.bfloat16: 1}
PLAIN_ROWS = 1 << 16         # rows the plain version routes at once


@dataclass(frozen=True)
class TreeTables:
    """A booster's tables on one device, flattened to (T * M,) in the
    full binary layout (node i's children 2i+1 / 2i+2)."""

    split_feature: torch.Tensor   # (T * M,) int32, < 0 at a leaf
    threshold: torch.Tensor       # (T * M,) int32 bins or float32 values
    leaf: torch.Tensor            # (T * M,) float32 or bfloat16
    tree_weight: torch.Tensor     # (T,) float32
    num_nodes: int                # M = 2^(max_depth+1) - 1
    max_depth: int
    num_class: int
    num_features: int             # every split feature is below it
    init_score: float

    @property
    def raw(self) -> bool:
        """Raw float32 features (``predict``) rather than bin ids."""
        return self.threshold.dtype == torch.float32

    @property
    def num_trees(self) -> int:
        return self.tree_weight.shape[0]


def _check(x: torch.Tensor, tables: TreeTables) -> None:
    t, m = tables.num_trees, tables.num_nodes
    if tables.threshold.dtype not in (torch.int32, torch.float32) \
            or tables.leaf.dtype not in LEAF_CODES:
        raise ValueError(f"tables: thresholds {tables.threshold.dtype}, "
                         f"leaves {tables.leaf.dtype}")
    for name, v, dtype, size in (
            ("split_feature", tables.split_feature, torch.int32, t * m),
            ("threshold", tables.threshold, tables.threshold.dtype, t * m),
            ("leaf", tables.leaf, tables.leaf.dtype, t * m),
            ("tree_weight", tables.tree_weight, torch.float32, t)):
        if v.dtype != dtype or tuple(v.shape) != (size,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"tables.{name} must be a contiguous {dtype} "
                             f"({size},) on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
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


def tree_score(x: torch.Tensor, tables: TreeTables) -> torch.Tensor:
    """(N, F) bin ids (uint8 / uint16 / int32, for int32 thresholds) or
    raw float32 features (for float32 thresholds), contiguous, on the
    tables' device -> (N,) or (N, K) float32 raw scores."""
    _check(x, tables)
    if x.device.type == "cpu":
        return tree_score_reference(x, tables)
    return _launch(x, tables)


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


def leaf_nodes(x: torch.Tensor, tables: TreeTables) -> torch.Tensor:
    """(rows, T) int64 leaf slot of every row in every tree: all trees
    routed at once, depth level by depth level, on a (rows, trees) node
    tensor indexed at ``t * M + node``; a leaf's node stays."""
    offsets = (torch.arange(tables.num_trees, device=x.device)
               * tables.num_nodes)[None, :]
    sf = tables.split_feature.long()
    thr = tables.threshold if tables.raw else tables.threshold.long()
    # gather takes no uint16, and bin ids compare as integers
    xs = x if tables.raw else x.long()
    node = torch.zeros((x.shape[0], tables.num_trees), dtype=torch.int64,
                       device=x.device)
    for _ in range(tables.max_depth):
        flat = node + offsets
        feat = sf[flat]
        fx = torch.gather(xs, 1, feat.clamp_min(0))
        left = (torch.isnan(fx) | (fx <= thr[flat])) if tables.raw \
            else fx <= thr[flat]
        child = 2 * node + 1
        node = torch.where(feat < 0, node, torch.where(left, child, child + 1))
    return node


def tree_score_reference(x: torch.Tensor, tables: TreeTables) -> torch.Tensor:
    """The plain version: a block of rows' leaves in every tree
    (``leaf_nodes``), then the trees' contributions added one by one in
    tree order (``_add_tree``): the JAX ``scan``'s left fold (a ``sum``
    or ``cumsum`` over the tree axis would add in another order). Rows
    are independent, so blocks of ``PLAIN_ROWS`` change no bit."""
    n, k = x.shape[0], tables.num_class
    dev = x.device
    offsets = (torch.arange(tables.num_trees, device=dev)
               * tables.num_nodes)[None, :]
    tw64 = tables.tree_weight.double()
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    for s in range(0, n, PLAIN_ROWS):
        node = leaf_nodes(x[s:s + PLAIN_ROWS], tables)
        # (T, rows): each leaf (bf16 promoted to float32 first) times its
        # tree's weight, exact in float64
        val = (tables.leaf[node + offsets].float().double() * tw64).t()
        acc = torch.full((k, node.shape[0]), tables.init_score,
                         dtype=torch.float32, device=dev)
        for t in range(tables.num_trees):
            _add_tree(acc[t % k], val[t])
        out[s:s + PLAIN_ROWS] = acc.t()
    return out[:, 0] if k == 1 else out


class StagedBatch:
    """The buffers of one padded batch shape of a served model: ``x``, a
    numpy view of the (rows, F) bin ids to score, and ``out``, one of
    their (rows, K) float32 scores, both in host memory (pinned when the
    tables lie on the card), and their twins on the tables' device.
    ``tree_score_staged`` scores them in one call."""

    def __init__(self, tables: TreeTables, rows: int, features: int,
                 dtype: torch.dtype):
        if tables.raw or dtype not in BIN_CODES:
            raise ValueError(f"a staged batch holds bin ids of "
                             f"{tuple(BIN_CODES)} for int32 thresholds, got "
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
        # the library's arguments that never change, read once: a torch
        # call on the serving thread can give up the interpreter lock
        self.args = (self.host_in.data_ptr(), self.dev_in.data_ptr(),
                     BIN_CODES[dtype], self.x.nbytes)


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
        *batch.args,
        tables.split_feature.data_ptr(), tables.threshold.data_ptr(),
        tables.leaf.data_ptr(), LEAF_CODES[tables.leaf.dtype],
        tables.tree_weight.data_ptr(), batch.dev_out.data_ptr(),
        batch.host_out.data_ptr(), ctypes.c_float(tables.init_score), n, f,
        tables.num_trees, tables.num_nodes, tables.max_depth,
        tables.num_class, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    bindings.check(lib, code, "tree_score staged batch")
    tree_score_launches += 1


def _launch(x: torch.Tensor, tables: TreeTables) -> torch.Tensor:
    global tree_score_launches
    lib = bindings.load("tree_score")
    n, k = x.shape[0], tables.num_class
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n:
        dev = x.device
        code = lib.mmls_tree_score(
            x.data_ptr(), RAW_CODE if tables.raw else BIN_CODES[x.dtype],
            tables.split_feature.data_ptr(), tables.threshold.data_ptr(),
            tables.leaf.data_ptr(), LEAF_CODES[tables.leaf.dtype],
            tables.tree_weight.data_ptr(), out.data_ptr(),
            ctypes.c_float(tables.init_score), n, x.shape[1],
            tables.num_trees, tables.num_nodes, tables.max_depth, k,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
        bindings.check(lib, code, "tree_score kernel launch")
        tree_score_launches += 1
    return out[:, 0] if k == 1 else out

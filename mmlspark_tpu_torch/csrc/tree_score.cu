// Tree-ensemble scoring for Hopper (sm_90a): every tree of a boosted
// ensemble over a batch of rows, in one launch.
//
// Replaces the JAX package's scorers, mmlspark_tpu/models/gbdt/booster.py
// predict_fn (:223, raw float32 features) and predict_binned_fn (:269, bin
// ids): a jax.jit of a lax.scan over the trees, one XLA program per shape,
// not a Pallas kernel. It computes what they return. Each tree is a full
// binary layout of `m` slots (node i's children 2i+1 / 2i+2); a row walks it
// from the root for at most `depth` steps, left where
//   - bin ids (uint8, uint16, int32): bin <= threshold_bin;
//   - raw float32 features: isnan(x) || x <= float32(threshold_value);
// and stops at the first leaf, the leaf the scan's "node stays" rule keeps.
// Tree t adds leaf * weight to class t % K of the row, in tree order, from
// float32(init_score), each add rounded once:
//   acc = float(double(acc) + double(leaf) * double(weight))
// The product of two float32 values is exact in float64, so the one
// rounding is the fused multiply-add XLA makes of the scan's
// acc + leaf * weight (ROADMAP C9; booster._add_tree). The intrinsics
// (__dadd_rn, __double2float_rn) fix that sequence whatever --fmad says.
// Routing is integer (or exact float) work and the fold a fixed sequence of
// float64 operations, so the kernel returns the plain version's bits
// (score_cuda.tree_score_reference).
//
// Tables (packed once per scorer, score_cuda.pack_nodes / make_tables). A leaf
// above the last level is pushed down its left spine: the leaf's slot and the
// spine's slots above the last level become always-left nodes (feature 0, the
// largest threshold) and the spine's last slot carries the leaf, so every walk
// takes exactly `depth` steps and no step tests for a leaf. Bin ids read one
// 32-bit word per node, [threshold_bin:16] [feature:16], 65535 being the
// always-left threshold; raw rows read 8 bytes per node, the int32 feature and
// the float32 threshold (+inf always left, NaN too). Past what a word holds (a
// threshold above 65,534, as an imported model's derived binning or a fit past
// 65,536 bins gives, or a split feature above 32,767) a booster's bin nodes
// are wide: 8 bytes, {int32 feature, int32 threshold}, as a raw node is,
// int32's largest the always-left threshold, and an id compares unclamped and
// signed, as the reference's bd[:, f] <= thr does (x codes 9, 10, 12: uint8,
// uint16 or int32 ids against wide nodes; each its own template instance, In =
// Wide<T>, so the narrow routes keep their code). The kernel reads the float64
// product leaf * weight of each slot (bfloat16 leaves promoted to float32
// first), made once per scorer: a fold is one load and one rounded add.
//
// Design. The fold is a chain of float32 roundings in tree order, so one
// thread per (row, class) folds every tree's product in order; what is
// split across threads is the walks. Two launch plans of one kernel family,
// chosen from the shapes by score_cuda.score_plan (plain Python):
//   - rows (large batches): persistent CTAs, a thread per row. A CTA stages
//     a chunk of the trees' tables in shared memory (as many trees as fit
//     beside its tile), then walks its tiles: of 1,024 rows, one CTA per SM,
//     where the batch fills the card and every tree fits; else of 256 rows.
//     A tile holds one 32-bit value per feature of each row, feature-major
//     ([f * R + r]), so the rows of a warp read distinct banks whatever
//     features they read. Each thread stages only its own row, so a tile
//     needs no barrier: bin ids arrive by 4-byte cp.async into a word
//     buffer while the thread walks the row before, then are widened into
//     the tile as id << 16 (clamped to 0..65535), which compares with the
//     whole node word; raw rows are copied after the walk (one tile, so
//     1,024 threads per SM fit). A thread walks its row through every tree
//     of the chunk, four walks in flight, a step being a node load, the
//     value's address (feature * 4R), a value load, a compare and the
//     child's shared address (2a - root + size, one node further right);
//     it folds the products in tree order into at most four class
//     accumulators in registers, rotated as the classes come round; more
//     classes go in passes of four over the chunk. No per-tree barrier and
//     no contribution buffer. Between chunks a row's running sums wait in
//     the float32 output (a float32 value, so nothing rounds). Trees too
//     large for shared memory (depth 13 and deeper in the full layout) or
//     rows too wide for a tile take the "global" route of the same kernel:
//     nothing is staged and the walks read the tables and rows from global
//     memory (L1/L2).
//   - cluster (small batches through many trees: a served batch): one
//     thread-block cluster of up to 8 CTAs per block of up to 64 rows. Rank
//     r stages and walks the trees [r*T/C, (r+1)*T/C) for every row of the
//     block, one walk per thread (four in flight), and writes each float64
//     product to its own shared memory. After cluster.sync() the threads of
//     rank 0, one per (row, class), read the products of every rank in
//     global tree order through distributed shared memory and fold them; a
//     second cluster.sync() keeps the other ranks' shared memory alive until
//     then. No global scratch, no atomics, no second launch.
//
// What bounds it. The function must read the (N, F) input once, the tables
// once and write the (N, K) float32 output: at N = 2M, F = 28 uint8 bin ids
// about 64 MB, some 19 us at 3.35 TB/s; its operations (depth compares and
// an add per row and tree) are far below the card's rates. The walk is not:
// each of 240M steps is two dependent shared-memory loads and five integer
// instructions, whose dispatch and latency set its time above the byte
// bound; at serving sizes the launch, the staging and the cluster's two
// barriers do (the T-long fold per (row, class) is a small part).
//
// The decision route (x code 6; mmls_tree_score_decision). It also
// replaces the routing of the JAX package's _go_left_fn (booster.py:162,
// XLA) and its leaf_index_fn (:452): raw float32 features against nodes
// that carry LightGBM's decision bits. It is its own template instance
// (In = DFloat), so the bin and raw routes above keep their code. A node
// is 8 bytes, like a raw node: [decision byte:8 at bit 16][feature:16] and
// either the float32 threshold (numeric) or the word offset of the node's
// category bitset (categorical, bit 0). A row goes left at a numeric node
// as _go_left_fn says: missing type (bits 2-3) 0 compares NaN as 0.0, 1
// sends 0.0 and NaN the default way (bit 1), 2 sends NaN the default way;
// everything else compares value <= threshold. At a categorical node the
// value is truncated toward zero and goes left where its bit is set in
// the node's bitset; NaN, negative and out-of-range values go right. The
// bitsets, (categorical nodes) x (words) uint32, are read where they lie,
// through the read-only cache. Pushed-down leaves sit behind nodes of
// decision byte 0 and threshold +inf, which every value passes (NaN
// compares as 0.0). With a `leaves` output the walk also writes, for each
// (row, tree), the slot where the reference's scan stops: `leaf_map`
// takes the last-level slot of the walk to the leaf that was pushed down
// to it (score_cuda.pack_decision_nodes). The slots are written tree-major,
// (trees, n): the threads of a warp walk neighbouring rows of one tree in
// both plans, so a warp's slots fill whole lines (row-major, a thread per
// row wrote one 4-byte word per 80-byte row). Scores and leaf slots come
// from one launch. The route's bound is bytes too: the input, tables,
// bitsets, output and (trees, n) int32 leaf slots once; its step is the
// raw route's plus the byte decode, a branch and, at a categorical node,
// a dependent load of a bitset word.

#include <cooperative_groups.h>

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWalks = 4;        // walks in flight per thread
constexpr int kAccRegs = 4;      // classes folded per pass, in registers
constexpr int kThreads = 256;    // cluster plan: threads of a CTA
constexpr int kBlockRows = 64;   // cluster plan: rows of a cluster's block
constexpr int kMaxCluster = 8;   // portable cluster size

// The category bitsets of the decision route, read where they lie, and
// the number of categories they hold (32 per word); unused by the other
// routes.
struct Bits {
  const uint32_t* words;
  float limit;
};

// A bin id scored against wide nodes: a type of its own (the size of T),
// so the wide route is a template instance of its own.
template <typename T>
struct Wide {
  T v;
  Wide() = default;
  __device__ explicit Wide(uint32_t w) : v(static_cast<T>(w)) {}
};

// A raw float32 feature scored by decision bits: a type of its own, so the
// decision route is a template instance of its own.
struct DFloat {
  float v;
  DFloat() = default;
  __device__ explicit DFloat(uint32_t w) {
    union {
      uint32_t u;
      float f;
    } bits{w};
    v = bits.f;
  }
};

// Nodes, staged row values and the left-routing rule per input type. A
// bin node is the word [threshold:16][feature:16] and a bin id is staged
// as min(max(id, 0), 65535) << 16, so a row goes left where its staged
// value is at most the whole word (unsigned: the feature below 65536
// breaks no tie); the clamp keeps every int32 id right of a real threshold
// (at most 65534) and left of the always-left one. A raw node is {feature,
// float32 threshold bits}; a row goes left where its value is NaN or at
// most the threshold (a NaN threshold sends only NaN left). A decision
// node (DFloat rows) routes by its decision byte, as the note at the top
// says. A wide bin node (Wide<T> rows) is {int32 feature, int32
// threshold}; an id is staged as its int32 value and goes left where it
// is at most the threshold, signed. kDirect: a row's 32-bit values are
// staged as they lie in memory (no widening pass).
template <typename In>
struct Node {  // bin ids: uint8, uint16, int32
  using Word = uint32_t;
  static constexpr bool kDecision = false;
  static constexpr bool kDirect = false;
  static __device__ __forceinline__ uint32_t feature(uint32_t w) {
    return __byte_perm(w, 0, 0x4410);  // the low half, zero-extended
  }
  static __device__ __forceinline__ uint32_t stage(In v) {
    int x = static_cast<int>(v);
    if (sizeof(In) == 4) x = min(max(x, 0), 65535);
    return static_cast<uint32_t>(x) << 16;
  }
  static __device__ __forceinline__ bool left(uint32_t s, uint32_t w,
                                              const Bits&) {
    return s <= w;
  }
};

template <typename T>
struct Node<Wide<T>> {  // bin ids against wide nodes
  using Word = int2;
  static constexpr bool kDecision = false;
  static constexpr bool kDirect = sizeof(T) == 4;
  static __device__ __forceinline__ uint32_t feature(int2 w) {
    return static_cast<uint32_t>(w.x);
  }
  static __device__ __forceinline__ uint32_t stage(Wide<T> v) {
    return static_cast<uint32_t>(static_cast<int>(v.v));
  }
  static __device__ __forceinline__ bool left(uint32_t s, int2 w,
                                              const Bits&) {
    return static_cast<int>(s) <= w.y;
  }
};

template <>
struct Node<float> {  // raw features
  using Word = int2;
  static constexpr bool kDecision = false;
  static constexpr bool kDirect = true;
  static __device__ __forceinline__ uint32_t feature(int2 w) {
    return static_cast<uint32_t>(w.x);
  }
  static __device__ __forceinline__ uint32_t stage(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ bool left(uint32_t s, int2 w,
                                              const Bits&) {
    const float v = __uint_as_float(s);
    return isnan(v) || v <= __int_as_float(w.y);
  }
};

template <>
struct Node<DFloat> {  // raw features under decision bits
  using Word = int2;
  static constexpr bool kDecision = true;
  static constexpr bool kDirect = true;
  static __device__ __forceinline__ uint32_t feature(int2 w) {
    return static_cast<uint32_t>(w.x) & 0xFFFFu;
  }
  static __device__ __forceinline__ uint32_t stage(DFloat v) {
    return __float_as_uint(v.v);
  }
  static __device__ __forceinline__ bool left(uint32_t s, int2 w,
                                              const Bits& b) {
    const float v = __uint_as_float(s);
    const uint32_t d = static_cast<uint32_t>(w.x) >> 16;
    if (d & 1u) {  // categorical: the bit of trunc(v) in the node's set
      const float t = truncf(v);
      if (!(t >= 0.f && t < b.limit)) return false;  // NaN fails both
      const uint32_t c = static_cast<uint32_t>(t);
      return (__ldg(b.words + w.y + (c >> 5)) >> (c & 31u)) & 1u;
    }
    const bool nan = isnan(v);
    const float x = nan ? 0.f : v;
    const uint32_t mt = (d >> 2) & 3u;
    const bool missing = mt == 2u ? nan : (mt == 1u && x == 0.f);
    return missing ? (d & 2u) != 0u : x <= __int_as_float(w.y);
  }
};

// Loads from shared memory at a 32-bit shared address.
__device__ __forceinline__ uint32_t lds(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void lds(uint32_t a, uint32_t& v) { v = lds(a); }
__device__ __forceinline__ void lds(uint32_t a, int2& v) {
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a));
}
__device__ __forceinline__ double lds_f64(uint32_t a) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n" : "=d"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one rounded add of the fold (C9)
__device__ __forceinline__ float fold(float acc, double prod) {
  return __double2float_rn(__dadd_rn(static_cast<double>(acc), prod));
}

// Four walks in shared memory, `depth` steps each. Walk i starts at the
// root of the tree whose nodes begin at shared address root[i] and reads
// its row's staged values at row[i] + stride * feature; it ends
// with node[i] the address of its last-level slot. A step reads the node,
// then the value, and moves to the child at 2a - root + size (left) or one
// node further (right).
template <typename In>
__device__ __forceinline__ void walk4(const uint32_t (&root)[kWalks],
                                      const uint32_t (&row)[kWalks],
                                      uint32_t stride, int depth,
                                      const Bits& bits,
                                      uint32_t (&node)[kWalks]) {
  using N = Node<In>;
  constexpr uint32_t kSize = sizeof(typename N::Word);
  uint32_t kl[kWalks], kr[kWalks];
#pragma unroll
  for (int i = 0; i < kWalks; ++i) {
    node[i] = root[i];
    kl[i] = kSize - root[i];
    kr[i] = kl[i] + kSize;
  }
  for (int d = 0; d < depth; ++d) {
    typename N::Word w[kWalks];
#pragma unroll
    for (int i = 0; i < kWalks; ++i) lds(node[i], w[i]);
#pragma unroll
    for (int i = 0; i < kWalks; ++i) {
      const uint32_t s = lds(row[i] + N::feature(w[i]) * stride);
      node[i] = 2 * node[i] + (N::left(s, w[i], bits) ? kl[i] : kr[i]);
    }
  }
}

// The same four walks over the tables and rows in global memory (the
// global route): tree ts[i]'s nodes, the row at `row`.
template <typename In>
__device__ __forceinline__ void walk4_global(const typename Node<In>::Word* tab,
                                             const long long (&toff)[kWalks],
                                             const In* row, int depth,
                                             const Bits& bits,
                                             int (&node)[kWalks]) {
  using N = Node<In>;
#pragma unroll
  for (int i = 0; i < kWalks; ++i) node[i] = 0;
  for (int d = 0; d < depth; ++d) {
#pragma unroll
    for (int i = 0; i < kWalks; ++i) {
      const typename N::Word w = tab[toff[i] + node[i]];
      const uint32_t s = N::stage(row[N::feature(w)]);
      node[i] = 2 * node[i] + (N::left(s, w, bits) ? 1 : 2);
    }
  }
}

struct Args {
  const void* x;        // (n, f) row-major
  const void* nodes;    // (trees * m) packed nodes
  const double* prod;   // (trees * m) leaf * weight
  float* out;           // (n, k)
  float init;
  long long n;
  int f, trees, m, depth, k;
  int rows;             // rows of a tile (rows plan) or of a cluster's block
  int chunk;            // trees staged at once (rows) or of a rank (cluster)
  int words;            // 32-bit words of a row, the last one partly used
  // the decision route only
  const uint32_t* bits;  // category bitsets, `bit_words` words each
  int bit_words;
  const int* leaf_map;   // (trees * m) last-level slot -> leaf slot
  int* leaves;           // (trees, n) leaf slots, or null
};

__device__ __forceinline__ Bits bits_of(const Args& a) {
  return Bits{a.bits, static_cast<float>(a.bit_words) * 32.f};
}

// The decision route's leaf output: row r's leaf slot in tree t, from the
// last-level slot its walk ended on, at [t * n + r].
__device__ __forceinline__ void write_leaf(const Args& a, long long r, int t,
                                           int slot) {
  a.leaves[t * a.n + r] =
      __ldg(a.leaf_map + static_cast<size_t>(t) * a.m + slot);
}

__host__ __device__ inline size_t align_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

// Shared-memory layout of both plans (score_cuda._smem_bytes computes the
// same): the nodes and products of `chunk` trees, [cluster: the walks'
// float64 products], the staged values of the tile's rows (feature f of
// row r at [f * R + r], a 32-bit value each: the rows of a warp read
// distinct banks whatever features they read), and [rows plan, rows not
// staged as they lie] the next tile's raw words (word w of row r at
// [w * R + r]).
struct Layout {
  size_t prod, walks, values, next, total;
  __host__ __device__ Layout(const Args& a, int node_bytes, bool direct,
                             bool cluster) {
    const size_t cells = static_cast<size_t>(a.chunk) * a.m;
    const size_t R = cluster ? kBlockRows : a.rows;
    prod = align_up(cells * node_bytes, 8);
    walks = prod + cells * 8;
    const size_t end = walks + (cluster ? a.chunk * R * 8 : 0);
    values = align_up(end, 16);
    next = values + static_cast<size_t>(a.f) * R * 4;
    total = cluster || direct ? next : next + R * 4 * a.words;
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Trees [t0, t0 + count): their nodes and products, asynchronously.
template <typename In>
__device__ __forceinline__ void stage_tables(const Args& a, uint32_t smem,
                                             const Layout& lay, int t0,
                                             int count) {
  using Word = typename Node<In>::Word;
  const size_t first = static_cast<size_t>(t0) * a.m;
  const size_t cells = static_cast<size_t>(count) * a.m;
  const uint32_t* nodes = reinterpret_cast<const uint32_t*>(
      static_cast<const Word*>(a.nodes) + first);
  for (size_t i = threadIdx.x; i < cells * sizeof(Word) / 4; i += blockDim.x)
    cp_async4(smem + 4 * i, nodes + i);
  for (size_t i = threadIdx.x; i < cells; i += blockDim.x)
    cp_async8(smem + lay.prod + 8 * i, a.prod + first + i);
}

// Whether rows copy as words: every row starts on a word (whole-word rows
// and a word-aligned base); else element by element.
template <typename In>
__device__ __forceinline__ bool word_rows(const Args& a) {
  return (a.f * sizeof(In)) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a.x) % 4 == 0;
}

template <typename In>
__device__ __forceinline__ const In* row_of(const Args& a, long long g) {
  return static_cast<const In*>(a.x) + static_cast<size_t>(g) * a.f;
}

// Row g's staged values into slot r of the value tile at shared address
// `values` (R rows), element by element from global memory.
template <typename In>
__device__ __forceinline__ void stage_values(const Args& a, uint32_t values,
                                             int r, long long g) {
  const int R = a.rows;
  const In* src = row_of<In>(a, g);
  for (int f = 0; f < a.f; ++f) {
    const uint32_t v = Node<In>::stage(src[f]);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(values + (f * R + r) * 4),
                 "r"(v)
                 : "memory");
  }
}

// Row g's raw words into slot r of a word-major tile at `dst` (R rows),
// asynchronously: the values themselves for raw rows, else words that
// widen() stages.
template <typename In>
__device__ __forceinline__ void copy_words(const Args& a, uint32_t dst, int r,
                                           long long g) {
  const int R = a.rows;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(row_of<In>(a, g));
  for (int w = 0; w < a.words; ++w) cp_async4(dst + (w * R + r) * 4, src + w);
}

// Slot r's raw bin-id words at `words` (word-major) staged into the value
// tile at `values`.
template <typename In>
__device__ __forceinline__ void widen(const Args& a, uint32_t words,
                                      uint32_t values, int r) {
  const int R = a.rows;
  constexpr int kPer = 4 / sizeof(In);
  for (int w = 0; w < a.words; ++w) {
    const uint32_t word = lds(words + (w * R + r) * 4);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = w * kPer + j;
      if (f < a.f) {
        const In v = static_cast<In>(word >> (8 * sizeof(In) * j));
        asm volatile("st.shared.u32 [%0], %1;\n"
                     ::"r"(values + (f * R + r) * 4), "r"(Node<In>::stage(v))
                     : "memory");
      }
    }
  }
}

// Rows of tile (or cluster block) `tile` of R rows: R, fewer in the last.
__device__ __forceinline__ int rows_in(const Args& a, long long tile, int R) {
  const long long left = a.n - tile * R;
  return static_cast<int>(left < R ? left : R);
}

// acc[0] belongs to the class of the next tree: after its fold the next
// class's accumulator moves to the front (gs classes in the pass).
__device__ __forceinline__ void rotate(float (&acc)[kAccRegs], int gs) {
  const float a0 = acc[0];
  acc[0] = acc[1];
  if (gs == 2) {
    acc[1] = a0;
  } else {
    acc[1] = acc[2];
    if (gs == 3) {
      acc[2] = a0;
    } else {
      acc[2] = acc[3];
      acc[3] = a0;
    }
  }
}

// The trees of classes [c0, c0 + gs) in tree order: the first at or after
// t, and the one after `tree` (of class `cls`).
__device__ __forceinline__ void first_tree(int t, int k, int c0, int gs,
                                           int& tree, int& cls) {
  const int q = t / k, c = t - q * k;
  if (c < c0) {
    tree = q * k + c0;
    cls = c0;
  } else if (c < c0 + gs) {
    tree = t;
    cls = c;
  } else {
    tree = (q + 1) * k + c0;
    cls = c0;
  }
}
__device__ __forceinline__ void next_tree(int k, int c0, int gs, int& tree,
                                          int& cls) {
  if (cls + 1 < c0 + gs) {
    ++tree;
    ++cls;
  } else {
    tree += k - gs + 1;
    cls = c0;
  }
}

// One row through the trees [t_lo, t_hi): a pass per four classes, each
// folding its classes' trees in tree order (four walks in flight) into
// registers; from init_score in the first chunk (t_lo == 0), else from
// the row's output. kShared: the chunk's nodes at shared address `nodes`,
// its products at `prods` and the row's values at `row` (one per feature,
// a.rows * 4 bytes apart); else all in global memory.
template <typename In, bool kShared>
__device__ __forceinline__ void score_row(const Args& a, uint32_t nodes,
                                          uint32_t prods, uint32_t row,
                                          const In* grow, float* o,
                                          long long r, int t_lo, int t_hi) {
  using Word = typename Node<In>::Word;
  constexpr int kSize = sizeof(Word);
  uint32_t rows[kWalks];
#pragma unroll
  for (int i = 0; i < kWalks; ++i) rows[i] = row;
  for (int c0 = 0; c0 < a.k; c0 += kAccRegs) {
    const int gs = min(kAccRegs, a.k - c0);
    int tree, cls;
    first_tree(t_lo, a.k, c0, gs, tree, cls);
    const int phase = cls - c0;  // acc[j] is class c0 + (phase + j) % gs
    float acc[kAccRegs];
#pragma unroll
    for (int j = 0; j < kAccRegs; ++j)
      acc[j] = t_lo == 0 || j >= gs ? a.init : o[c0 + (phase + j) % gs];
    int folded = 0;
    while (tree < t_hi) {
      int ts[kWalks], count = 0;
#pragma unroll
      for (int i = 0; i < kWalks; ++i) {
        ts[i] = tree < t_hi ? tree : ts[0];  // a spare walk repeats one
        if (tree < t_hi) {
          count = i + 1;
          if (gs == a.k) {
            ++tree;  // every class in this pass: the trees follow each other
          } else {
            next_tree(a.k, c0, gs, tree, cls);
          }
        }
      }
      double p[kWalks];
      if (kShared) {
        uint32_t root[kWalks], node[kWalks];
#pragma unroll
        for (int i = 0; i < kWalks; ++i)
          root[i] = nodes + (ts[i] - t_lo) * a.m * kSize;
        walk4<In>(root, rows, a.rows * 4, a.depth, bits_of(a), node);
#pragma unroll
        for (int i = 0; i < kWalks; ++i)
          p[i] = lds_f64(prods + (node[i] - nodes) * (8 / kSize));
        if (Node<In>::kDecision && a.leaves != nullptr) {
#pragma unroll
          for (int i = 0; i < kWalks; ++i)
            if (i < count)
              write_leaf(a, r, ts[i], (node[i] - root[i]) / kSize);
        }
      } else {
        long long toff[kWalks];
        int node[kWalks];
#pragma unroll
        for (int i = 0; i < kWalks; ++i)
          toff[i] = static_cast<long long>(ts[i]) * a.m;
        walk4_global<In>(static_cast<const Word*>(a.nodes), toff, grow,
                         a.depth, bits_of(a), node);
#pragma unroll
        for (int i = 0; i < kWalks; ++i) p[i] = a.prod[toff[i] + node[i]];
        if (Node<In>::kDecision && a.leaves != nullptr) {
#pragma unroll
          for (int i = 0; i < kWalks; ++i)
            if (i < count) write_leaf(a, r, ts[i], node[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kWalks; ++i) {
        if (i < count) {
          acc[0] = fold(acc[0], p[i]);
          if (gs > 1) rotate(acc, gs);
        }
      }
      folded += count;
    }
    const int next = (phase + folded) % gs;
#pragma unroll
    for (int j = 0; j < kAccRegs; ++j)
      if (j < gs) o[c0 + (next + j) % gs] = acc[j];
  }
}

// Rows plan: a thread per row. kShared: tables and rows staged in shared
// memory, each thread staging and reading only its own row (so a tile
// needs no barrier); else every read goes to global memory (the "global"
// route).
template <typename In, bool kShared>
__global__ void __launch_bounds__(1024, 1)
    score_rows_kernel(const Args a) {
  using Word = typename Node<In>::Word;
  constexpr bool kDirect = Node<In>::kDirect;  // rows staged as they lie
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(a, sizeof(Word), kDirect, false);
  const uint32_t base = shared_addr(smem);
  const long long tiles = (a.n + a.rows - 1) / a.rows;
  const bool words = word_rows<In>(a);
  const int chunk = max(kShared ? a.chunk : a.trees, 1);
  const int tid = threadIdx.x;
  // the tile's values, and for bin ids the next row's raw words
  const uint32_t values = base + lay.values;
  const uint32_t next_words = base + lay.next;

  // with no trees, one pass writes init_score
  for (int t_lo = 0; t_lo == 0 || t_lo < a.trees; t_lo += chunk) {
    const int t_hi = min(a.trees, t_lo + chunk);
    long long tile = blockIdx.x;
    if (kShared) {
      __syncthreads();  // the last chunk's walks are done with the tables
      stage_tables<In>(a, base, lay, t_lo, t_hi - t_lo);
      const bool mine = tile < tiles && tid < rows_in(a, tile, a.rows);
      if (mine && !words)
        stage_values<In>(a, values, tid, tile * a.rows + tid);
      else if (mine)
        copy_words<In>(a, kDirect ? values : next_words, tid,
                       tile * a.rows + tid);
      cp_async_commit();
      cp_async_wait<0>();
      if (mine && words && !kDirect) widen<In>(a, next_words, values, tid);
      __syncthreads();  // the tables are staged
    }
    for (; tile < tiles; tile += gridDim.x) {
      const long long r = tile * a.rows + tid;
      const long long next = tile + gridDim.x;
      const bool more = next < tiles && tid < rows_in(a, next, a.rows);
      if (kShared && words && !kDirect && more) {
        // the next row's bin ids land while this one is walked
        copy_words<In>(a, next_words, tid, next * a.rows + tid);
        cp_async_commit();
      }
      if (r < a.n) {
        float* o = a.out + r * a.k;
        if (kShared) {
          score_row<In, true>(a, base, base + lay.prod, values + tid * 4,
                              nullptr, o, r, t_lo, t_hi);
        } else {
          score_row<In, false>(a, 0, 0, 0, row_of<In>(a, r), o, r, t_lo,
                               t_hi);
        }
      }
      if (kShared && more) {
        // this thread's walk is done with its values: stage its next row
        if (!words) {
          stage_values<In>(a, values, tid, next * a.rows + tid);
        } else if (kDirect) {
          copy_words<In>(a, values, tid, next * a.rows + tid);
          cp_async_commit();
          cp_async_wait<0>();
        } else {
          cp_async_wait<0>();
          widen<In>(a, next_words, values, tid);
        }
      }
    }
    if (kShared) cp_async_wait<0>();  // a CTA left without a tile
  }
}

// Cluster plan: the trees split over the CTAs of a cluster, the fold on
// rank 0 through distributed shared memory.
template <typename In>
__global__ void __launch_bounds__(kThreads)
    score_cluster_kernel(const Args a) {
  using Word = typename Node<In>::Word;
  constexpr int kSize = sizeof(Word);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout lay(a, kSize, Node<In>::kDirect, true);
  const uint32_t base = shared_addr(smem);
  const long long block = blockIdx.x / ranks;
  const long long row0 = block * kBlockRows;
  const int nb = rows_in(a, block, kBlockRows);
  const int lo = static_cast<int>(static_cast<long long>(rank) * a.trees /
                                  ranks);
  const int hi = static_cast<int>(static_cast<long long>(rank + 1) * a.trees /
                                  ranks);
  double* s_prod = reinterpret_cast<double*>(smem + lay.walks);

  stage_tables<In>(a, base, lay, lo, hi - lo);
  cp_async_commit();
  // the block's staged values, feature by feature (plain stores, so the
  // loads of several iterations are in flight at once)
  const uint32_t values = base + static_cast<uint32_t>(lay.values);
  uint32_t* s_values = reinterpret_cast<uint32_t*>(smem + lay.values);
#pragma unroll 4
  for (int i = threadIdx.x; i < nb * a.f; i += blockDim.x) {
    const int f = i / nb, r = i - f * nb;
    s_values[f * kBlockRows + r] =
        Node<In>::stage(row_of<In>(a, row0 + r)[f]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // walk w is (tree lo + w / nb, row w % nb): the threads of a warp take
  // neighbouring rows of one tree; four walks per thread in flight
  const int walks = nb * (hi - lo);
  for (int w0 = threadIdx.x; w0 < walks; w0 += kWalks * blockDim.x) {
    uint32_t root[kWalks], row[kWalks], node[kWalks];
    int tl[kWalks], rl[kWalks];
#pragma unroll
    for (int i = 0; i < kWalks; ++i) {
      const int w = w0 + i * static_cast<int>(blockDim.x);
      const int ww = w < walks ? w : w0;  // a spare walk repeats the first
      tl[i] = ww / nb;
      rl[i] = ww - tl[i] * nb;
      root[i] = base + tl[i] * a.m * kSize;
      row[i] = values + rl[i] * 4;
    }
    walk4<In>(root, row, kBlockRows * 4, a.depth, bits_of(a), node);
#pragma unroll
    for (int i = 0; i < kWalks; ++i) {
      if (w0 + i * static_cast<int>(blockDim.x) < walks) {
        s_prod[tl[i] * nb + rl[i]] =
            lds_f64(base + lay.prod + (node[i] - base) * (8 / kSize));
        if (Node<In>::kDecision && a.leaves != nullptr)
          write_leaf(a, row0 + rl[i], lo + tl[i], (node[i] - root[i]) / kSize);
      }
    }
  }
  cluster.sync();
  if (rank == 0) {
    // one thread per (row, class): every rank's products in tree order,
    // read eight at a time so their loads overlap
    constexpr int kBatch = 8;
    for (int p = threadIdx.x; p < nb * a.k; p += blockDim.x) {
      const int c = p / nb, r = p - c * nb;
      float acc = a.init;
      for (int o = 0; o < ranks; ++o) {
        const int olo = static_cast<int>(static_cast<long long>(o) * a.trees /
                                         ranks);
        const int ohi = static_cast<int>(
            static_cast<long long>(o + 1) * a.trees / ranks);
        const double* rp = cluster.map_shared_rank(s_prod, o);
        // the first tree of class c at or after olo
        for (int t = olo + ((c - olo % a.k) % a.k + a.k) % a.k; t < ohi;
             t += kBatch * a.k) {
          double v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int tj = t + j * a.k;
            v[j] = tj < ohi ? rp[(tj - olo) * nb + r] : 0.0;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            if (t + j * a.k < ohi) acc = fold(acc, v[j]);
        }
      }
      a.out[(row0 + r) * a.k + c] = acc;
    }
  }
  cluster.sync();  // the other ranks' products stay until rank 0 is done
}

struct Plan {
  int regime;  // 0 rows, 1 cluster
  int rows, ctas, cluster, chunk, smem, shared;
};

// Lets the kernel take up to the device's opt-in shared memory, once per
// instantiation (In, kKind: 0 rows, 1 cluster) and device.
template <typename In, int kKind, typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load() & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename In>
cudaError_t launch(const Args& a, const Plan& p, int device, cudaStream_t s) {
  const bool cluster = p.regime == 1;
  if ((p.regime != 0 && p.regime != 1) ||
      (cluster ? p.rows != kBlockRows
               : p.rows < 32 || p.rows > 1024 || p.rows % 32 != 0) ||
      p.ctas < 1 ||
      p.cluster < 1 || p.cluster > kMaxCluster || p.ctas % p.cluster != 0 ||
      (cluster && !p.shared) || (!cluster && p.cluster != 1) || p.smem < 0)
    return cudaErrorInvalidConfiguration;
  if (p.shared) {
    const Layout lay(a, sizeof(typename Node<In>::Word), Node<In>::kDirect,
                     cluster);
    if (lay.total > static_cast<size_t>(p.smem) || p.chunk < 0 ||
        (cluster && p.chunk * static_cast<long long>(p.cluster) < a.trees) ||
        (!cluster && a.trees > 0 && p.chunk < 1))
      return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (!cluster) {
    auto kernel = p.shared ? score_rows_kernel<In, true>
                           : score_rows_kernel<In, false>;
    if (p.shared && p.smem > 48 * 1024 &&
        (err = allow_smem<In, 0>(kernel, device)) != cudaSuccess)
      return err;
    kernel<<<p.ctas, p.rows, p.shared ? p.smem : 0, s>>>(a);
    return cudaGetLastError();
  }
  auto kernel = score_cluster_kernel<In>;
  if (p.smem > 48 * 1024 &&
      (err = allow_smem<In, 1>(kernel, device)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_rows(Args a, const Plan& p, int device, cudaStream_t s) {
  a.words = (a.f * static_cast<int>(sizeof(In)) + 3) / 4;
  return launch<In>(a, p, device, s);
}

cudaError_t launch_x(int x_code, const Args& a, const Plan& p, int device,
                     cudaStream_t s) {
  switch (x_code) {
    case 1:
      return launch_rows<uint8_t>(a, p, device, s);
    case 2:
      return launch_rows<uint16_t>(a, p, device, s);
    case 4:
      return launch_rows<int32_t>(a, p, device, s);
    case 5:
      return launch_rows<float>(a, p, device, s);
    case 6:
      return launch_rows<DFloat>(a, p, device, s);
    case 9:
      return launch_rows<Wide<uint8_t>>(a, p, device, s);
    case 10:
      return launch_rows<Wide<uint16_t>>(a, p, device, s);
    case 12:
      return launch_rows<Wide<int32_t>>(a, p, device, s);
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* x, const void* nodes, const void* prod, void* out,
               float init, long long n, int f, int trees, int m, int depth,
               int k, const Plan& p) {
  Args a;
  a.x = x;
  a.nodes = nodes;
  a.prod = static_cast<const double*>(prod);
  a.out = static_cast<float*>(out);
  a.init = init;
  a.n = n;
  a.f = f;
  a.trees = trees;
  a.m = m;
  a.depth = depth;
  a.k = k;
  a.rows = p.rows;
  a.chunk = p.chunk;
  a.words = 0;
  a.bits = nullptr;
  a.bit_words = 0;
  a.leaf_map = nullptr;
  a.leaves = nullptr;
  return a;
}

}  // namespace

extern "C" {

// Scores the row-major (n, f) `x` through `trees` trees of `m` slots on
// `stream` (a cudaStream_t) of device `device`, into the row-major (n, k)
// float32 `out`. x_code: 1 uint8, 2 uint16, 4 int32 bin ids against packed
// 32-bit nodes; 9, 10, 12 the same ids against wide 8-byte bin nodes; 5
// raw float32 features against packed 8-byte nodes. `prod`
// holds each slot's float64 leaf * weight; every walk takes `depth` steps.
// The plan (score_cuda.score_plan): regime 0 rows / 1 cluster, rows per
// tile or block, CTAs, CTAs per cluster, trees per chunk or rank, dynamic
// shared-memory bytes, and whether tables and rows are staged in shared
// memory. Returns the first CUDA error: 0 on success.
int mmls_tree_score(const void* x, int x_code, const void* nodes,
                    const void* prod, void* out, float init_score,
                    long long n, int f, int trees, int m, int depth, int k,
                    int regime, int rows, int ctas, int cluster, int chunk,
                    int smem, int shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Plan p{regime, rows, ctas, cluster, chunk, smem, shared};
  return (int)launch_x(x_code,
                       make_args(x, nodes, prod, out, init_score, n, f, trees,
                                 m, depth, k, p),
                       p, device, (cudaStream_t)stream);
}

// The decision route: raw float32 rows (x code 6) against 8-byte decision
// nodes, the categorical nodes' bitsets `bits` (`bit_words` uint32 words
// each, at the word offset the node holds), and with a non-null `leaves`
// the int32 leaf slot of every row in every tree, tree-major (trees, n),
// through `leaf_map` ((trees * m) int32). Otherwise as mmls_tree_score.
int mmls_tree_score_decision(const void* x, const void* nodes,
                             const void* prod, void* out, float init_score,
                             long long n, int f, int trees, int m, int depth,
                             int k, const void* bits, int bit_words,
                             const void* leaf_map, void* leaves, int regime,
                             int rows, int ctas, int cluster, int chunk,
                             int smem, int shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bits == nullptr || bit_words < 1 || leaf_map == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p{regime, rows, ctas, cluster, chunk, smem, shared};
  Args a = make_args(x, nodes, prod, out, init_score, n, f, trees, m, depth,
                     k, p);
  a.bits = static_cast<const uint32_t*>(bits);
  a.bit_words = bit_words;
  a.leaf_map = static_cast<const int*>(leaf_map);
  a.leaves = static_cast<int*>(leaves);
  return (int)launch_x(6, a, p, device, (cudaStream_t)stream);
}

// One served batch in one call: copies the (n, f) rows from the pinned
// `host_x` to `x` on the card, scores them as mmls_tree_score does into
// `out`, copies the (n, k) scores to the pinned `host_out`, and waits for
// the stream. Returns the first CUDA error: 0 on success.
int mmls_tree_score_staged(const void* host_x, void* x, int x_code,
                           long long x_bytes, const void* nodes,
                           const void* prod, void* out, void* host_out,
                           float init_score, long long n, int f, int trees,
                           int m, int depth, int k, int regime, int rows,
                           int ctas, int cluster, int chunk, int smem,
                           int shared, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const Plan p{regime, rows, ctas, cluster, chunk, smem, shared};
  err = cudaMemcpyAsync(x, host_x, x_bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_x(x_code,
                 make_args(x, nodes, prod, out, init_score, n, f, trees, m,
                           depth, k, p),
                 p, device, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_out, out, n * k * sizeof(float),
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

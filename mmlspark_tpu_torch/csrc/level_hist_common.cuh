// What the two level-histogram kernels (level_hist.cu, float32 stats in
// fixed point; level_hist_quant.cu, int16/int8 stats) share: the stable
// counting partition of the rows by node that both histograms walk, the
// cp.async helpers that stage their chunks (uint16 rows as the words that
// cover them), the launch grid, the histogram of both planes on int32
// ids (a gather into node-ordered columns and a walk over tiles of bins
// in shared memory, below), and the elementwise dequantization of their
// int64 sums.
//
// The partition, in place of a sort, three launches that wait on no host:
//   plan_count: each warp counts its segment of kSegRows rows per key (the
//     node, or width for a row the plane does not keep; the lanes of one
//     key add once, by __match_any_sync; each lane loads kBatch rows at
//     once), and hands every row to the plane's Rows (below), which writes
//     what the histogram gathers per row.
//   plan_scan (one CTA): the exclusive prefix sum of the per-CTA counts in
//     key-major order and the nodes' offsets; then the plane's own tail.
//   plan_scatter: each warp walks its segment again and writes every kept
//     row's id to its place, so node w's rows are order[offsets[w] :
//     offsets[w + 1]] in row order: the order of a stable sort by node.
//
// A plane's Rows is a struct with
//   static bool keep(float live)          which rows the plane sums;
//   struct Max                            what a thread gathers over its rows;
//   void put(int64_t r, float live, Max&) write row r's stats (every row);
//   void merge(Max&)                      a warp's end of the count pass;
//   void finish_scan(int tid, int64_t n)  plan_scan's tail (tid < 1024).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace level_hist {

constexpr int kDequantThreads = 256;
constexpr int kSegRows = 512;        // rows per warp segment of the partition
constexpr int kBatch = 8;            // rows per lane loaded at once (a warp: 256)
constexpr int kPlanWarps = 8;        // warps per CTA of the partition (at most)
constexpr int kPlanSmem = 48 * 1024; // the partition's per-warp key counters
// the widest level the key counters of one warp hold (hist_cuda.MAX_WIDTH)
constexpr int kMaxWidth = kPlanSmem / (int)sizeof(int) - 1;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Row r's key: its node, or width for a row the plane does not keep (and
// for an id outside [0, width), the caller's bug: such a row is left out).
template <class Rows, typename L>
__device__ __forceinline__ int row_key(const L* __restrict__ local, float lv,
                                       int64_t r, int width) {
  const long long w = local[r];
  return Rows::keep(lv) && w >= 0 && w < width ? (int)w : width;
}

// 1. The counts and the rows' stats. Warp segment s counts its rows per
// key into wcounts[key * ns + s], and each CTA its warps' sums into
// btot[key * nb + cta].
template <typename L, class Rows>
__global__ void __launch_bounds__(kPlanWarps * 32)
plan_count_kernel(const L* __restrict__ local, const float* __restrict__ live,
                  Rows rows, int* __restrict__ wcounts, int* __restrict__ btot,
                  int64_t n, int width, int ns, int nb) {
  extern __shared__ int plan_smem[];
  const int keys = width + 1, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* mine = plan_smem + warp * keys;
  for (int k = lane; k < keys; k += 32) mine[k] = 0;
  __syncwarp();
  const int64_t seg = (int64_t)blockIdx.x * warps + warp;
  const int64_t r1 = min64(n, (seg + 1) * kSegRows);
  typename Rows::Max m;
  for (int64_t base = seg * kSegRows; base < r1; base += 32 * kBatch) {
    int key[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t r = base + 32 * i + lane;
      key[i] = -1;
      if (r < r1) {
        const float lv = live[r];
        rows.put(r, lv, m);
        key[i] = row_key<Rows>(local, lv, r, width);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[i]);
      if (key[i] >= 0 && lane == __ffs(peers) - 1) mine[key[i]] += __popc(peers);
      __syncwarp();
    }
  }
  if (seg < ns)
    for (int k = lane; k < keys; k += 32) wcounts[(int64_t)k * ns + seg] = mine[k];
  __syncthreads();
  for (int k = threadIdx.x; k < keys; k += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += plan_smem[w * keys + k];
    btot[(int64_t)k * nb + blockIdx.x] = sum;
  }
  rows.merge(m);
}

// 2. One CTA: the exclusive prefix sum of btot in key-major order (key,
// then CTA), in place and 1,024 entries at a time, so btot[key * nb + c]
// is where CTA c's first row of that key goes; offsets[w] = btot[w * nb]
// (offsets[width]: the kept rows); then the plane's tail.
template <class Rows>
__global__ void __launch_bounds__(1024)
plan_scan_kernel(int* __restrict__ btot, int64_t* __restrict__ offsets,
                 Rows rows, int64_t n, int width, int nb) {
  __shared__ long long warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t total = (int64_t)(width + 1) * nb;
  long long carry = 0;
  for (int64_t t0 = 0; t0 < total; t0 += 1024) {
    const int64_t e = t0 + tid;
    const long long v = e < total ? btot[e] : 0;
    long long incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      warp_sums[lane] = w;                           // inclusive over warps
    }
    __syncthreads();
    if (e < total)
      btot[e] = (int)(carry + incl - v + (warp > 0 ? warp_sums[warp - 1] : 0));
    carry += warp_sums[31];
    __syncthreads();                                 // warp_sums is rewritten
  }
  for (int k = tid; k <= width; k += 1024) offsets[k] = btot[(int64_t)k * nb];
  rows.finish_scan(tid, n);
}

// 3. The stable scatter: warp segment s starts each key at its CTA's place
// (btot) plus the counts of the CTA's earlier warps, walks its rows in
// order again, and the lanes of one key take consecutive places in lane
// order: order[place] = row for every kept row. Node w's rows then lie at
// order[offsets[w] : offsets[w + 1]] in row order, as a stable sort by
// node puts them; rows the plane does not keep get no place.
template <typename L, class Rows>
__global__ void __launch_bounds__(kPlanWarps * 32)
plan_scatter_kernel(const L* __restrict__ local, const float* __restrict__ live,
                    const int* __restrict__ wcounts,
                    const int* __restrict__ btot, int64_t* __restrict__ order,
                    int64_t n, int width, int ns, int nb) {
  extern __shared__ int plan_smem[];
  const int keys = width + 1, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* next = plan_smem + warp * keys;               // the segment's next place per key
  const int64_t seg = (int64_t)blockIdx.x * warps + warp;
  if (seg >= ns) return;
  for (int k = lane; k < keys; k += 32) {
    int place = btot[(int64_t)k * nb + blockIdx.x];
    for (int64_t q = seg - warp; q < seg; ++q) place += wcounts[(int64_t)k * ns + q];
    next[k] = place;
  }
  __syncwarp();
  const int64_t r1 = min64(n, (seg + 1) * kSegRows);
  for (int64_t base = seg * kSegRows; base < r1; base += 32 * kBatch) {
    int key[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t r = base + 32 * i + lane;
      key[i] = -1;
      if (r < r1) {
        const int k = row_key<Rows>(local, live[r], r, width);
        if (k < width) key[i] = k;
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[i]);
      if (key[i] >= 0) {
        order[next[key[i]] + __popc(peers & lanes_below())] = base + 32 * i + lane;
      }
      __syncwarp();
      if (key[i] >= 0 && lane == __ffs(peers) - 1) next[key[i]] += __popc(peers);
      __syncwarp();
    }
  }
}

// The three launches on stream s. Scratch: wcounts (width + 1) * ns and
// btot (width + 1) * nb int32 for ns = ceil(n / kSegRows) warp segments
// and nb = ceil(ns / kPlanWarps) CTAs (at most; fewer warps per CTA where
// the key counters of 8 warps would not fit kPlanSmem); offsets width + 1
// and order n int64. width must not pass kMaxWidth.
template <typename L, class Rows>
cudaError_t plan(const L* local, const float* live, Rows rows, int* wcounts,
                 int* btot, int64_t* offsets, int64_t* order, int64_t n,
                 int width, cudaStream_t s) {
  const int keys = width + 1;
  int warps = kPlanSmem / (keys * (int)sizeof(int));
  warps = warps < kPlanWarps ? warps : kPlanWarps;
  if (warps < 1) return cudaErrorInvalidValue;
  const int ns = (int)((n + kSegRows - 1) / kSegRows);
  const int nb = (ns + warps - 1) / warps;
  const int smem = warps * keys * (int)sizeof(int);
  plan_count_kernel<L, Rows><<<nb, warps * 32, smem, s>>>(
      local, live, rows, wcounts, btot, n, width, ns, nb);
  plan_scan_kernel<Rows><<<1, 1024, 0, s>>>(btot, offsets, rows, n, width, nb);
  plan_scatter_kernel<L, Rows><<<nb, warps * 32, smem, s>>>(
      local, live, wcounts, btot, order, n, width, ns, nb);
  return cudaGetLastError();
}

// Where the scatter's btot starts in the counts scratch (after wcounts).
inline int64_t plan_wcounts(int64_t n, int width) {
  return (int64_t)(width + 1) * ((n + kSegRows - 1) / kSegRows);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// The 4-byte words a uint16 row's slice of ids spans once staged: the words
// covering ids [e, e + fs) of the row-major (n, f) ids, e = r * f + f0
// counted from the tensor's start (on a 4-byte boundary), so a row's ids
// start at the low (e even) or high (e odd) half of its first word. That
// is ceil(f_slice / 2) words, and one more where f_slice is even and the
// rows' starts alternate (f odd); the narrower last slice fits the same
// (hist_cuda.u16_words).
__host__ __device__ inline int u16_words(int f, int f_slice) {
  return (f_slice + 1) / 2 + (f_slice % 2 == 0 && f % 2 == 1 ? 1 : 0);
}

// Where a uint16 kernel keeps the cells of its slice of fs features
// (hist_cuda.u16_cell): in planes of u16_plane_words(f_slice, tile_bins)
// words, rows of 32 words in which feature fl owns the g = floor(32 / fs)
// banks [g * fl, g * fl + g), bin at word (bin / g) * 32 + g * fl + bin %
// g. The g rows a warp instruction adds per feature then fall on g banks,
// and two features never share a bank. bin / g by a multiply-high with m =
// ceil(2^32 / g) (m = 2^32 where g = 1), exact for bin < 2^16.
struct U16Cells {
  int g;
  unsigned m_lo, m_hi;
  __device__ U16Cells(int fs, int /*tile_bins*/) : g(32 / fs) {
    const unsigned long long m = ((1ull << 32) + g - 1) / g;
    m_lo = (unsigned)m;
    m_hi = (unsigned)(m >> 32);
  }
  __device__ __forceinline__ int at(int fl, int bin) const {
    const int q = (int)(__umulhi((unsigned)bin, m_lo) + (m_hi ? (unsigned)bin : 0u));
    return q * 32 + g * fl + (bin - q * g);
  }
};

// The words of one plane of a uint16 kernel's cells: rows of 32 words for
// ceil(tile_bins / floor(32 / f_slice)) groups of bins (an even number,
// as the float32 kernel's staging after them needs).
__host__ __device__ inline int u16_plane_words(int f_slice, int tile_bins) {
  const int g = 32 / f_slice;
  return (tile_bins + g - 1) / g * 32;
}

// cp.async of word q of the words covering ids [e, e + fs) of `ids`, a
// uint16 (n, f) matrix read as 4-byte words, to dst[q]; nothing for a q
// past the row's last word.
__device__ __forceinline__ void stage_u16_word(unsigned* dst,
                                               const unsigned* __restrict__ ids,
                                               int64_t e, int fs, int q) {
  if (q <= (int)(((e + fs - 1) >> 1) - (e >> 1)))
    cp_async4(dst + q, ids + (e >> 1) + q);
}

// A histogram launch's grid (hist_cuda.launch_grid): the SMs, the CTAs an
// SM holds at `smem` bytes (the occupancy API), the CTAs launched, and the
// CTAs each tile of bins takes. uint8 ids, one tile: a CTA per SM slot,
// and at least one per feature slice. uint16 ids: one wave at most.
// per_tile = max(num_slices, floor(wave / num_tiles)) CTAs per tile, so
// every slice of every tile has one, and where the tiles' CTAs pass a
// wave the launched CTAs take them in turn (a CTA loops over the
// "virtual" CTAs v = blockIdx.x, blockIdx.x + gridDim.x, ...). int32 ids:
// at most one wave, min(wave, num_slices * num_tiles) CTAs (the items of
// a width-1 level), which take the (node, feature, tile) items in turn;
// per_tile = num_slices, a CTA per feature of a tile and node.
struct HistGrid {
  int sms, per_sm, ctas, per_tile;
};

template <class Kernel>
cudaError_t hist_grid(Kernel kernel, int threads, int smem, int bin_bytes,
                      int num_slices, int num_tiles, int device, HistGrid* g) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&g->sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g->per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (g->per_sm < 1 || num_slices < 1 || num_tiles < 1)
    return cudaErrorInvalidConfiguration;
  const int wave = g->sms * g->per_sm;
  if (bin_bytes == 4) {  // int32 ids: at most one wave takes the items
    const int64_t width1 = (int64_t)num_slices * num_tiles;
    g->ctas = width1 < wave ? (int)width1 : wave;
    g->per_tile = num_slices;
    return cudaSuccess;
  }
  if (bin_bytes != 2) {  // uint8 ids
    g->ctas = g->per_tile = wave > num_slices ? wave : num_slices;
    return cudaSuccess;
  }
  const int even = wave / num_tiles;
  g->per_tile = even > num_slices ? even : num_slices;
  const int64_t all = (int64_t)g->per_tile * num_tiles;
  g->ctas = all < wave ? (int)all : wave;
  return cudaSuccess;
}

// The histogram of both planes on int32 bin ids (B past 65,536, the
// reference's ids past uint16, mmlspark_tpu/ops/ingest.py:
// binned_ingest_dtype). One feature's int64 cells, B x 3 x 8 bytes, are
// 1.5 MB at B = 65,537, past a CTA's shared memory, so the bins go in
// tiles: an item is one (node, feature, tile of bins) and owns the int64
// cells of its tile_bins bins (hist_cuda.i32_plan: 9,363 bins, 14 tiles,
// at B = 131,072), as two 32-bit planes per channel in shared memory
// (level_hist.cu's split-word adds), 24 bytes a bin. Two launches before
// it make every (node, feature) a contiguous run:
//   - the partition's scatter (plan above) puts the kept rows in node
//     order, as the uint8 and uint16 instances have them;
//   - gather_i32_kernel copies each kept row's ids into (f, n)
//     column-major scratch at its place in that order, with each id's
//     tile key beside it in a column of bytes (the low byte of bin /
//     tile_bins), and the row's stats (float4 on the float32 plane, the
//     packed quanta on the quantized one) in a column of their own.
// The item's CTA streams its node's run of its feature's key column, four
// keys a word compared at once (__vcmpeq4), through L2: the tiles of one
// (node, feature) are consecutive items, taken by CTAs at about the same
// time, so the re-reads hit L2, and a byte a place is a quarter of what
// the ids would cost. Only for places whose key is its tile's does it read
// the id (its bin, checked exactly: keys repeat every 256 tiles, and ids
// outside [0, b) are the caller's bug and fall in no tile) and the row's
// stats. A lane takes 32 places per step (8 words) and adds its matches
// two at a time (both loads in flight), merging a run of pairs in one
// cell in registers before it adds into shared memory, so a column with
// 90% of its rows in one bin does not serialise on one address; at the
// end a warp whose lanes all hold one cell adds it once. Its epilogue
// writes each cell of the tile once: on the one-pass entries the float32
// histogram, dequantized as dequantize_kernel does; on the quantized
// plane's chunk-merge entry the nonzero cells added into the caller's
// int64 sums (the item owns them: no atomics). No int64 plane of every
// cell is made, zeroed or read back. The grid is at most one wave of
// CTAs (one per SM: the cells fill its shared memory; no more than a
// width-1 level's items) taking items in turn from a counter, tiles
// fastest. Integer sums are order-free: the bits are the plain
// versions'. What bounds it is in level_hist.cu's note; the random reads
// of the matched ids and stats (a 32-byte sector each) take most of the
// walk's time on the card.
//
// A plane's Terms is a copy-constructible struct with
//   Terms ready() const                 read what the walk needs once;
//   Stat load(int64_t p) const          the stats of the row at place p;
//   void add(Stat, long long& s0, long long& s1, long long& s2) const
//                                       add that row's three int64 terms.
// An Out is a copy-constructible struct with
//   Out ready() const                   read what the epilogue needs once;
//   void write(cells, tile_bins, dst cell, bt, tid) const
//                                       write the tile's bt cells (and
//                                       clear them: take_cell).
constexpr int kI32Threads = 1024;
constexpr int kI32Words = 8;          // key words a lane loads at once
constexpr int kI32CellWords = 6;      // 32-bit words of a cell
constexpr int kGatherWarps = 8;
constexpr int kGatherCtas = 4096;

// The stride of the key columns: n rounded up to 16 bytes, so that every
// column starts on a word.
__host__ __device__ inline int64_t i32_key_stride(int64_t n) {
  return (n + 15) / 16 * 16;
}

// 1. Each kept row's ids into its place p of the node order, column by
// column (cols[k * n + p]), each id's tile key to keys[k * n4 + p], and
// its stats to nstats[p]. A warp takes 32 places: it reads their rows'
// ids 32 features at a time, a row per load (coalesced), into a 32 x 33
// tile of shared memory, and writes each feature's 32 places as one
// coalesced run.
template <typename S>
__global__ void __launch_bounds__(kGatherWarps * 32)
gather_i32_kernel(const int32_t* __restrict__ ids,     // (n, f) row-major
                  const S* __restrict__ stats,         // (n,) by row
                  const int64_t* __restrict__ order,   // kept rows by node
                  const int64_t* __restrict__ offsets, // (width + 1,)
                  S* __restrict__ nstats, int32_t* __restrict__ cols,
                  uint8_t* __restrict__ keys, int64_t n, int f, int width,
                  int tile_bins) {
  __shared__ int32_t tiles[kGatherWarps][32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t (*tile)[33] = tiles[warp];
  const int64_t kept = offsets[width], n4 = i32_key_stride(n);
  for (int64_t p0 = ((int64_t)blockIdx.x * kGatherWarps + warp) * 32;
       p0 < kept; p0 += (int64_t)gridDim.x * kGatherWarps * 32) {
    const int64_t p = p0 + lane;
    const bool in = p < kept;
    const int64_t r = in ? order[p] : 0;
    if (in) nstats[p] = stats[r];
    const int rows = kept - p0 < 32 ? (int)(kept - p0) : 32;
    for (int k0 = 0; k0 < f; k0 += 32) {
      const int k = k0 + lane;
#pragma unroll
      for (int i = 0; i < 32; ++i) {               // 32 loads in flight
        const int64_t ri = __shfl_sync(0xffffffffu, r, i);
        if (i < rows && k < f) tile[i][lane] = __ldg(ids + ri * f + k);
      }
      __syncwarp();
      const int kn = f - k0 < 32 ? f - k0 : 32;
      if (in)
        for (int j = 0; j < kn; ++j) {
          const int32_t id = tile[lane][j];
          cols[(k0 + j) * n + p] = id;
          keys[(k0 + j) * n4 + p] = (uint8_t)((unsigned)id / (unsigned)tile_bins);
        }
      __syncwarp();                                  // the tile is spent
    }
  }
}

// Where a launch's int32 scratch lies in `wide`: the items' counter (16
// bytes), the node-ordered stats (n of S), the id columns (f x n int32),
// the key columns (f x i32_key_stride(n) bytes)
// (hist_cuda.i32_scratch_bytes).
template <typename S>
struct I32Scratch {
  unsigned long long* work;
  S* nstats;
  int32_t* cols;
  uint8_t* keys;
  I32Scratch(void* wide, int64_t n, int f)
      : work((unsigned long long*)wide),
        nstats((S*)((char*)wide + 16)),
        cols((int32_t*)((char*)wide + 16 + n * (int64_t)sizeof(S))),
        keys((uint8_t*)(cols + f * n)) {}
};

template <typename S>
cudaError_t gather_i32(const void* ids, const S* stats, const int64_t* order,
                       const int64_t* offsets, const I32Scratch<S>& w,
                       int64_t n, int f, int width, int tile_bins,
                       cudaStream_t s) {
  const int64_t want = (n + kGatherWarps * 32 - 1) / (kGatherWarps * 32);
  const int ctas = (int)(want < kGatherCtas ? want : kGatherCtas);
  gather_i32_kernel<S><<<ctas, kGatherWarps * 32, 0, s>>>(
      (const int32_t*)ids, stats, order, offsets, w.nstats, w.cols, w.keys,
      n, f, width, tile_bins);
  return cudaGetLastError();
}

// The three int64 terms s0..s2 into cell `bin` of the tile's planes: add64
// per channel, the three low words' atomics issued first so that their
// old values come back in one round trip.
__device__ __forceinline__ void add_cell(unsigned* cells, int tile_bins,
                                         int bin, long long s0, long long s1,
                                         long long s2) {
  unsigned* lo = cells + bin;
  const unsigned l0 = (unsigned)s0, l1 = (unsigned)s1, l2 = (unsigned)s2;
  const unsigned o0 = atomicAdd(lo, l0);
  const unsigned o1 = atomicAdd(lo + 2 * tile_bins, l1);
  const unsigned o2 = atomicAdd(lo + 4 * tile_bins, l2);
  const unsigned h0 = (unsigned)(s0 >> 32) + (o0 + l0 < o0 ? 1u : 0u);
  const unsigned h1 = (unsigned)(s1 >> 32) + (o1 + l1 < o1 ? 1u : 0u);
  const unsigned h2 = (unsigned)(s2 >> 32) + (o2 + l2 < o2 ? 1u : 0u);
  if (h0) atomicAdd(lo + tile_bins, h0);
  if (h1) atomicAdd(lo + 3 * tile_bins, h1);
  if (h2) atomicAdd(lo + 5 * tile_bins, h2);
}

// Cell `bin`, channel c of the tile's planes as an int64, and the cell
// cleared for the next item.
__device__ __forceinline__ long long take_cell(unsigned* cells, int tile_bins,
                                               int bin, int c) {
  unsigned* lo = cells + 2 * c * tile_bins + bin;
  const long long v =
      (long long)((unsigned long long)lo[tile_bins] << 32 | lo[0]);
  lo[0] = lo[tile_bins] = 0u;
  return v;
}

// The places of a key word whose bytes equal the key's (0xFF per equal
// byte from __vcmpeq4), as 4 bits, byte j at bit j: the top bit of each
// byte, gathered by one multiply (no two partial products share a bit).
__device__ __forceinline__ unsigned byte_bits(unsigned eq) {
  return ((eq & 0x80808080u) * 0x00204081u) >> 28;
}

// 2. The histogram: items v = (w * f + fl) * num_tiles + t. The cells are
// zeroed once; each item's epilogue clears what it reads.
template <class Terms, class Out>
__global__ void __launch_bounds__(kI32Threads, 1)
hist_i32_kernel(const int32_t* __restrict__ cols,    // (f, n) node order
                const uint8_t* __restrict__ keys,    // (f, n4) tile keys
                const Terms terms_in, const Out out_in,
                const int64_t* __restrict__ offsets, // (width + 1,)
                unsigned long long* __restrict__ work,  // zero on entry
                int64_t n, int f, int b, int width, int tile_bins,
                int num_tiles) {
  extern __shared__ unsigned cells[];                // [6][tile_bins]
  __shared__ unsigned long long item;
  const Terms terms = terms_in.ready();
  const Out out = out_in.ready();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kI32Threads / 32, kStep = 32 * kI32Words;
  const int64_t n4 = i32_key_stride(n);
  const unsigned long long items =
      (unsigned long long)width * f * num_tiles;
  for (int i = tid; i < kI32CellWords * tile_bins; i += kI32Threads)
    cells[i] = 0u;
  for (;;) {
    __syncthreads();        // the cells are clear, the last item's `item` read
    if (tid == 0) item = atomicAdd(work, 1ull);
    __syncthreads();
    const unsigned long long v = item;
    if (v >= items) return;
    const int t = (int)(v % num_tiles);
    const int64_t wf = (int64_t)(v / num_tiles);
    const int w = (int)(wf / f);
    const int64_t fl = wf - (int64_t)w * f;
    const int t0 = t * tile_bins;
    const int bt = b - t0 < tile_bins ? b - t0 : tile_bins;

    // node w's run [p0, p1) of column fl, as the key words [q0, q1); each
    // warp takes kStep words at a time, the next step's loading while it
    // adds this step's
    const int64_t p0 = offsets[w], p1 = offsets[w + 1];
    const int64_t q0 = p0 >> 2, q1 = (p1 + 3) >> 2;
    const int32_t* col = cols + fl * n;
    const unsigned* kw = reinterpret_cast<const unsigned*>(keys + fl * n4);
    const unsigned key = (unsigned)(t & 255) * 0x01010101u;
    struct Words {
      unsigned v[kI32Words];
    };
    auto load = [&](int64_t qb) {
      Words x;
#pragma unroll
      for (int k = 0; k < kI32Words; ++k) {
        const int64_t q = qb + k * 32 + lane;
        x.v[k] = q < q1 ? __ldcg(kw + q) : ~key;
      }
      return x;
    };
    int cur = -1;                                    // the lane's run's cell
    long long s0 = 0, s1 = 0, s2 = 0;
    // one of the lane's matches: its bin in the tile (or past bt: none)
    // and its stats
    auto merge = [&](unsigned bin, const typename Terms::Stat& st) {
      if (bin >= (unsigned)bt) return;
      if ((int)bin != cur) {
        if (cur >= 0) add_cell(cells, tile_bins, cur, s0, s1, s2);
        cur = (int)bin;
        s0 = s1 = s2 = 0;
      }
      terms.add(st, s0, s1, s2);
    };
    int64_t qb = q0 + (int64_t)warp * kStep;
    Words next = load(qb);
    for (; qb < q1; qb += (int64_t)kWarps * kStep) {
      const Words word = next;
      next = load(qb + (int64_t)kWarps * kStep);
      // the lane's places whose key is the tile's: bit 4k + j is byte j
      // of word k, place 4 * (qb + 32k + lane) + j, inside [p0, p1)
      unsigned rest = 0;
#pragma unroll
      for (int k = 0; k < kI32Words; ++k) {
        const int64_t q = qb + k * 32 + lane;
        unsigned eq = __vcmpeq4(word.v[k], key);
        if (q == q0) eq &= ~0u << (8 * (int)(p0 & 3));
        if (q == q1 - 1 && (p1 & 3)) eq &= (1u << (8 * (int)(p1 & 3))) - 1u;
        rest |= byte_bits(eq) << (4 * k);
      }
      // two matches at a time, their ids' and stats' loads in flight
      while (__any_sync(0xffffffffu, rest != 0)) {
        int64_t pa = -1, pb = -1;
        if (rest) {
          const int j = __ffs(rest) - 1;
          rest &= rest - 1;
          pa = 4 * (qb + (j >> 2) * 32 + lane) + (j & 3);
        }
        if (rest) {
          const int j = __ffs(rest) - 1;
          rest &= rest - 1;
          pb = 4 * (qb + (j >> 2) * 32 + lane) + (j & 3);
        }
        unsigned ba = ~0u, bb = ~0u;
        typename Terms::Stat sa{}, sb{};
        if (pa >= 0) {
          ba = (unsigned)__ldcg(col + pa) - (unsigned)t0;
          sa = terms.load(pa);
        }
        if (pb >= 0) {
          bb = (unsigned)__ldcg(col + pb) - (unsigned)t0;
          sb = terms.load(pb);
        }
        merge(ba, sa);
        merge(bb, sb);
      }
    }
    // the lanes' last runs: a warp whose lanes all hold one cell (a
    // skewed column's default bin) sums them by shuffles and adds once
    if (__match_any_sync(0xffffffffu, cur) == 0xffffffffu) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      }
      if (lane == 0 && cur >= 0) add_cell(cells, tile_bins, cur, s0, s1, s2);
    } else if (cur >= 0) {
      add_cell(cells, tile_bins, cur, s0, s1, s2);
    }
    __syncthreads();                                 // every add has landed
    out.write(cells, tile_bins, wf * b + t0, bt, tid);
  }
}

// The one-pass entries' epilogue: the tile's cells as float32,
// float(double(sum) * scale(c)) with dequantize_kernel's rounding, into
// the (width, f, b, 3) histogram at cell `dst` (= (w * f + fl) * b + t0).
template <class Scale>
struct DequantOut {
  float* __restrict__ out;
  Scale scale;
  double s0, s1, s2;
  __device__ DequantOut ready() const {
    DequantOut o = *this;
    o.s0 = scale(0);
    o.s1 = scale(1);
    o.s2 = scale(2);
    return o;
  }
  __device__ void write(unsigned* cells, int tile_bins, int64_t dst,
                        int bt, int tid) const {
    float* o = out + dst * 3;
    for (int i = tid; i < 3 * bt; i += kI32Threads) {
      const int c = i % 3, bin = i / 3;
      const double s = c == 0 ? s0 : (c == 1 ? s1 : s2);
      o[i] = __double2float_rn(
          __dmul_rn(__ll2double_rn(take_cell(cells, tile_bins, bin, c)), s));
    }
  }
};

// The chunk-merge entry's epilogue: the tile's nonzero cells added into
// the caller's (width, f, b, 3) int64 sums; the item owns them.
struct MergeOut {
  long long* __restrict__ acc;
  __device__ MergeOut ready() const { return *this; }
  __device__ void write(unsigned* cells, int tile_bins, int64_t dst,
                        int bt, int tid) const {
    long long* o = acc + dst * 3;
    for (int bin = tid; bin < bt; bin += kI32Threads) {
      const long long v0 = take_cell(cells, tile_bins, bin, 0);
      const long long v1 = take_cell(cells, tile_bins, bin, 1);
      const long long v2 = take_cell(cells, tile_bins, bin, 2);
      if (v0 | v1 | v2) {
        o[bin * 3] += v0;
        o[bin * 3 + 1] += v1;
        o[bin * 3 + 2] += v2;
      }
    }
  }
};

// The dynamic shared memory of a hist_i32_kernel CTA
// (hist_cuda.i32_smem_bytes).
inline int i32_smem(int tile_bins) {
  return kI32CellWords * (int)sizeof(unsigned) * tile_bins;
}

// The histogram's launch on stream s, over the columns of a gather: the
// items' counter zeroed, then one wave of CTAs (hist_grid).
template <class Terms, class Out, typename S>
cudaError_t launch_i32(const I32Scratch<S>& w, const Terms& terms,
                       const Out& out, const int64_t* offsets, int64_t n,
                       int f, int b, int width, int tile_bins, int num_tiles,
                       int device, cudaStream_t s) {
  HistGrid g;
  const int smem = i32_smem(tile_bins);
  cudaError_t err = hist_grid(hist_i32_kernel<Terms, Out>, kI32Threads,
                              smem, 4, f, num_tiles, device, &g);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(w.work, 0, sizeof(*w.work), s);
  if (err != cudaSuccess) return err;
  hist_i32_kernel<Terms, Out><<<g.ctas, kI32Threads, smem, s>>>(
      w.cols, w.keys, terms, out, offsets, w.work, n, f, b, width, tile_bins,
      num_tiles);
  return cudaGetLastError();
}

// The tiles a launch on int32 ids takes: every bin in one, the last not
// empty (hist_cuda.i32_plan).
inline bool i32_tiles_ok(int b, int tile_bins, int num_tiles) {
  return tile_bins >= 1 && num_tiles >= 1 &&
         (int64_t)tile_bins * num_tiles >= b &&
         (int64_t)tile_bins * (num_tiles - 1) < b;
}

// out[i] = float(double(acc[i]) * scale(i % 3)): int64 -> double rounds to
// nearest even (exact below 2^53), the product by a power of two is exact,
// and the cast to float rounds to nearest even. `Scale` maps a channel to
// its double scale on the device.
template <class Scale>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const long long* __restrict__ acc, float* __restrict__ out,
                  Scale scale, int64_t n) {
  const double s0 = scale(0), s1 = scale(1), s2 = scale(2);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % 3);
    const double s = c == 0 ? s0 : (c == 1 ? s1 : s2);
    out[i] = __double2float_rn(__dmul_rn(__ll2double_rn(acc[i]), s));
  }
}

template <class Scale>
cudaError_t dequantize(const long long* acc, float* out, Scale scale,
                       int64_t n, cudaStream_t stream) {
  const int64_t want = (n + kDequantThreads - 1) / kDequantThreads;
  const int blocks = (int)(want < 65535 ? want : 65535);
  dequantize_kernel<<<blocks, kDequantThreads, 0, stream>>>(acc, out, scale,
                                                           n);
  return cudaGetLastError();
}

}  // namespace level_hist

// What the two level-histogram kernels (level_hist.cu, float32 stats in
// fixed point; level_hist_quant.cu, int16/int8 stats) share: the stable
// counting partition of the rows by node that both histograms walk, the
// cp.async helpers that stage their chunks (uint16 rows as the words that
// cover them), the launch grid, the histogram walk of both planes on
// int32 ids (below), and the elementwise dequantization of their int64
// sums.
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
// and order n int64. width must not pass kMaxWidth. Without `scatter`
// only the counts, the rows' stats and the scan's tail are made (order is
// not written).
template <typename L, class Rows>
cudaError_t plan(const L* local, const float* live, Rows rows, int* wcounts,
                 int* btot, int64_t* offsets, int64_t* order, int64_t n,
                 int width, cudaStream_t s, bool scatter = true) {
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
  if (scatter)
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
// "virtual" CTAs v = blockIdx.x, blockIdx.x + gridDim.x, ...).
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
  if (bin_bytes != 2) {  // uint8 ids; int32 ids (one slice, one tile)
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
// binned_ingest_dtype). One feature's int64 cells, B x 3 x 8 bytes, pass
// a CTA's shared memory from about 9,700 bins and are 1.5 MB at B =
// 65,537, so no cell lives in shared memory: each (row, feature) pair is
// read once and its three int64 terms go straight into the zeroed int64
// sums in global memory by 64-bit atomics (RED.ADD.64 at an L2 slice;
// two's-complement adds give the exact signed sum in any order), at
// 64-bit cell offsets (width x F x B x 3 passes 2^31 at B = 131,072).
// A warp takes an item of kI32Rows consecutive rows and up to 32
// features, a lane per feature: the lanes read a row's ids as one
// coalesced run and the row's node and stats once (a broadcast), and
// each lane adds a run of rows that fall in one cell (the same node and
// bin, as a skewed column's default bin gives) into registers before one
// atomic per channel. Rows walk in their own order, so no sorted order is
// needed: the partition's count pass (Rows) still makes the float32
// plane's stats and exponents, and the quantized plane reads its stats
// directly. The grid is one wave of CTAs looping over the items.
//
// A plane's Terms is a copy-constructible struct with
//   Terms ready() const                 read what the walk needs once;
//   I32Row row(int64_t r) const         row r's node (-1: not kept) and
//                                       int64 terms.
constexpr int kI32Threads = 256;
constexpr int kI32Rows = 128;   // rows of a warp's item
constexpr int kI32Batch = 8;    // rows whose loads a lane starts at once

struct I32Row {
  int w;
  long long t0, t1, t2;
};

__device__ __forceinline__ void add_cell(unsigned long long* __restrict__ acc,
                                         int64_t cell, long long t0,
                                         long long t1, long long t2) {
  unsigned long long* dst = acc + cell * 3;
  if (t0) atomicAdd(dst, (unsigned long long)t0);
  if (t1) atomicAdd(dst + 1, (unsigned long long)t1);
  if (t2) atomicAdd(dst + 2, (unsigned long long)t2);
}

template <class Terms>
__global__ void __launch_bounds__(kI32Threads)
hist_i32_kernel(const int32_t* __restrict__ ids,   // (n, f) row-major
                const Terms terms_in,
                unsigned long long* __restrict__ acc,  // (width, f, b, 3)
                int64_t n, int f, int b) {
  const Terms terms = terms_in.ready();
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int ftiles = (f + 31) >> 5;
  const int64_t items = (n + kI32Rows - 1) / kI32Rows * ftiles;
  for (int64_t v = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
       v < items; v += (int64_t)gridDim.x * warps) {
    const int64_t c = v / ftiles;
    const int fl = (int)(v - c * ftiles) * 32 + lane;
    if (fl >= f) continue;
    const int64_t r0 = c * kI32Rows, r1 = min64(n, r0 + kI32Rows);
    int64_t cur = -1;                                // the run's cell
    long long s0 = 0, s1 = 0, s2 = 0;
    for (int64_t base = r0; base < r1; base += kI32Batch) {
      I32Row rows[kI32Batch];
      int bins[kI32Batch];
#pragma unroll
      for (int i = 0; i < kI32Batch; ++i) {
        const int64_t r = base + i;
        if (r < r1) {
          rows[i] = terms.row(r);
          bins[i] = ids[r * f + fl];
        } else {
          rows[i].w = -1;
        }
      }
#pragma unroll
      for (int i = 0; i < kI32Batch; ++i) {
        // out-of-range ids are the caller's bug: never write past the sums
        if (rows[i].w < 0 || (unsigned)bins[i] >= (unsigned)b) continue;
        const int64_t cell = ((int64_t)rows[i].w * f + fl) * b + bins[i];
        if (cell != cur) {
          if (cur >= 0) add_cell(acc, cur, s0, s1, s2);
          cur = cell;
          s0 = s1 = s2 = 0;
        }
        s0 += rows[i].t0;
        s1 += rows[i].t1;
        s2 += rows[i].t2;
      }
    }
    if (cur >= 0) add_cell(acc, cur, s0, s1, s2);
  }
}

// One launch of hist_i32_kernel on stream s over a one-wave grid.
template <class Terms>
cudaError_t launch_i32(const void* ids, const Terms& terms, void* acc,
                       int64_t n, int f, int b, int device, cudaStream_t s) {
  HistGrid g;
  const cudaError_t err = hist_grid(hist_i32_kernel<Terms>, kI32Threads, 0,
                                    4, 1, 1, device, &g);
  if (err != cudaSuccess) return err;
  hist_i32_kernel<Terms><<<g.ctas, kI32Threads, 0, s>>>(
      (const int32_t*)ids, terms, (unsigned long long*)acc, n, f, b);
  return cudaGetLastError();
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

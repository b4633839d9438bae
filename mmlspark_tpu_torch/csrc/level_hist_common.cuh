// What the two level-histogram kernels (level_hist.cu, float32 stats in
// fixed point; level_hist_quant.cu, int16/int8 stats) share: the stable
// counting partition of the rows by node that both histograms walk, the
// cp.async helpers that stage their chunks, and the elementwise
// dequantization of their int64 sums.
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

// Per-level GBDT histogram for Hopper (sm_90a), float32 stats summed in
// fixed point: the same bits in any order, on any device.
//
// Replaces the TPU kernel mmlspark_tpu/models/gbdt/hist_pallas.py:_hist_kernel
// (driven by _pallas_level_histogram). It computes what that kernel returns,
// a (width, F, B, 3) float32 histogram whose cell (node, f, bin) holds the
// sums of grad*live, hess*live and live over the rows of `node` whose
// feature f falls in `bin`, with one rounding fixed by the data rather than
// by the order of the adds:
//
//   - per channel c one power of two 2^e_c, e_c the largest integer with
//     n * amax_c * 2^e_c <= 2^62 (amax_c the largest |value| over the n
//     rows; e_c = 0 where amax_c = 0), found on the device by integer
//     exponent arithmetic (no exp2);
//   - each term round_half_even(double(x) * 2^e_c) as an int64 (the product
//     is exact: a power of two times a float);
//   - the int64 sums, exact and order-free (|sum| <= 2^62 + n/2 < 2^63);
//   - float(double(sum) * 2^-e_c), the chain level_hist_quant.cu uses.
//
// At n = 2M rows a term of the largest magnitude is about 2^41, a grid
// finer than float32's by some 2^17, so float sums land within any float32
// order's error bound, and integer-valued stats whose sums are exact in
// float32 come back bit for bit. The plain version
// (hist_cuda.level_histogram_reference) computes the same function with one
// int64 index_add_; the TPU kernel accumulates in grid order, so its fits
// are reproducible too. The float atomics this kernel used before made the
// card's float32 fit change from run to run.
//
// Why not a block-by-block copy of the TPU design. The Pallas kernel runs
// its grid in order on one core, so a node's accumulator stays in VMEM over
// consecutive row blocks, and it turns binning into a one-hot matmul on the
// MXU. Neither holds here: CTAs run in parallel and in no order, and a
// one-hot product would spend B times the operations for nothing.
//
// Design. Five launches on the stream, none waiting on the host (the fit's
// host syncs stay flat in the tree count):
//   1-3. the stable counting partition of the rows by node that both
//      planes share (level_hist_common.cuh), in place of a sort; this
//      plane keeps the rows with live != 0 (F32Rows). Its count pass also
//      writes each row's (grad*live, hess*live, live, 0) as one float4 and
//      the channels' amax, and its scan's tail computes e_c, the largest e
//      with n * amax_c * 2^e <= 2^62, by integer exponent arithmetic;
//   4. the histogram. The grid is persistent: one CTA of 1,024 threads per
//      SM, the CTAs split over the feature slices (at most 32 features
//      each) in proportion to their features. Each CTA of a slice takes an
//      equal run of the sorted kept rows and walks it node by node in
//      chunks of kChunk = 256 rows, double-buffered: while it adds one
//      chunk, cp.async gathers the next chunk's stats and bin bytes (32-bit
//      copies where rows are whole words) into shared memory, and the rows
//      of the chunk after that are prefetched into L2. A chunk's three
//      int64 terms per row are scaled and rounded once per row, not once
//      per feature. Then one warp adds a row, a lane per feature, into the
//      CTA's int64 cells in shared memory: each cell is two 32-bit words
//      added by two native 32-bit atomics with a carry (add64), and the
//      words of (bin, feature) sit at bin * 32 + feature, so the 32 lanes
//      of a warp always hit 32 different banks (195,840 B at B = 255). The
//      CTA flushes its cells into the zeroed int64 sums with 64-bit global
//      atomics, clearing them as it goes, only where its run leaves a node:
//      about (SMs + width) flushes per slice and level, where a CTA per
//      4,096-row tile made n / 4,096 + width;
//   5. the elementwise dequantization (level_hist_common.cuh).
//
// Bin ids past 256 bins. uint8 ids (B <= 256) take the kernel above.
// uint16 ids (B <= 65,536, the reference's ids past 256 bins,
// mmlspark_tpu/ops/ingest.py:binned_ingest_dtype) take a kernel of their
// own, level_hist_u16_kernel, in which each (row, feature) pair is added
// by exactly one CTA. Lane-private cells of 32 lanes would take 768 B per
// bin, so past about 290 bins no feature slice of them fits a CTA; cutting
// the bins into tiles instead would make every tile's CTAs stage and walk
// every row again (five tiles at B = 1,023). Here the slices are narrower
// instead (hist_cuda.f32_plan: the widest whose cells of every bin fit
// beside the staging: 8 features at B = 1,023, 15 at 511, 2 at 4,095,
// each slice a share of the grid), and the cells hold only the slice's
// features: cell (feature fl, bin) of word q (2c the low and 2c + 1 the
// high word of channel c) at cells[q * plane + U16Cells.at(fl, bin)]
// (level_hist_common.cuh: feature fl owns g = floor(32 / fs) banks). A
// warp adds g rows at once, a lane per (row, feature), so each feature's
// g lanes fall on its g banks and no two features meet in one; the adds
// are the same add64 into the same int64 cells, the flushes as above. A row's stats and row id are staged once per slice, its ids
// once in all: by cp.async of the 4-byte words that cover the slice's ids
// (hist_cuda.u16_words; rows of odd F start at either half of a word, and
// the row's parity, kept beside its terms, picks the half). Only where one
// feature's bins pass a CTA (about 8,700) do tiles remain: one feature per
// slice, each tile's CTAs its own run of the rows. The grid is one wave at
// most (level_hist_common.cuh: hist_grid); where the tiles' CTAs pass it,
// the launched CTAs take them in turn. The sums stay exact and order-free.
//
// Bin ids past 65,536 bins. int32 ids (the reference's ids past uint16)
// take level_hist_common.cuh's int32 histogram: one feature's int64 cells
// no longer fit a CTA, so after the partition (its scatter too) a gather
// copies the kept rows' ids into node-ordered columns, with their tile
// keys and float4 stats beside them, and each CTA item owns one (node,
// feature, tile of about 9,400 bins), whose int64 cells sit in shared
// memory as above (split 32-bit words), streams its node's run of its
// feature's tile keys and adds the pairs in its tile, a run of one cell
// merged in registers first. Its
// epilogue dequantizes the tile into `out` once: no int64 plane, no
// separate dequantization. Same terms, same sums, same one rounding: the
// same bits as the plain version in any order.
//
// What bounds it. Per level the function must read the N x F bin bytes,
// the three (N,) float32 vectors and the (N,) node ids (int64 on the
// training path), and write the float32 histogram: at N = 2M, F = 28 about
// 96 MB, some 29 us at the H100 SXM's 3.35 TB/s. The arithmetic (3 scaled
// adds per live row and feature) is far below the card's rate, so the bound
// is bytes. Over it: the partition reads the node ids and live twice;
// below the root a node's rows sit at scattered addresses, so a row costs
// a 32-byte sector of stats and one or two of bin bytes; and six 32-bit
// shared atomics per (row, feature), one wavefront each, set the
// histogram's pace. On int32 ids the output dominates the bound (at B =
// 131,072 and width 32 the float32 histogram is 1.41 GB); over it, the
// gather writes and reads the columns once more, and each of a (node,
// feature)'s tiles (14 at B = 131,072) reads its run of the column again,
// from L2 where the tiles' CTAs keep pace.
//
// Rows split over ranks (multi-device fits, models/gbdt/parallel_modes.py).
// The one-pass entry takes amax_c and e_c from its own rows, so a rank
// cannot use it: its terms would sit on another grid than the serial fit's.
// Three more entries split it: mmls_level_hist_amax writes each channel's
// amax over the rank's rows (one grid-stride pass, float bits merged by
// atomicMax); the caller reduces them over the ranks (max) and takes e_c
// from the global amax and the global row count
// (hist_cuda.fixed_point_exponents); mmls_level_hist_sums runs the same
// partition and histogram under those e_c, adding the exact int64 sums
// into the caller's accumulator with no rounding (uint8 and uint16 ids by
// the kernels' flush atomics, int32 ids by MergeOut, each item adding its
// tile's nonzero cells); the caller reduces the sums over the ranks (an
// integer sum, the same in any order) and mmls_level_hist_round rounds
// them once with the one-pass entry's expression. Same terms, same sums,
// same rounding: the serial fit's histogram, bit for bit, however the rows
// are split.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

using namespace level_hist;

constexpr int kThreads = 1024;       // one CTA per SM: its cells fill shared memory
constexpr int kLanes = 32;           // a warp per row, a lane per feature
constexpr int kChunk = 256;          // rows staged at once (hist_cuda.CHUNK_ROWS)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// The largest e with n * a * 2^e <= 2^62, exactly: a = m * 2^(ea - 24) with
// m = frexp's mantissa * 2^24, an integer; with L the bit length of n * m,
// e = 86 - ea - L, plus 1 where n * m is a power of two. 0 where a = 0.
__device__ int fixed_point_exponent(float a, long long n) {
  if (!(a > 0.f)) return 0;
  int ea;
  const float ma = frexpf(a, &ea);
  const unsigned long long nm =
      (unsigned long long)n * (unsigned long long)ldexpf(ma, 24);
  const int len = 64 - __clzll((long long)nm);
  return 86 - ea - len + ((nm & (nm - 1)) == 0 ? 1 : 0);
}

// The float32 plane's rows for the partition (level_hist_common.cuh): it
// keeps live != 0; the count pass writes each row's (grad*live, hess*live,
// live, 0) to stats[r] as one float4 (so the histogram gathers one 16-byte
// value per row, not three scattered floats), and every warp merges its
// maxima of their magnitudes into amax_bits by integer atomicMax on the
// float bits (non-negative floats order as their bits; amax_bits zeroed);
// the scan's tail turns them into e_c.
struct F32Rows {
  const float* __restrict__ grad;
  const float* __restrict__ hess;
  float4* __restrict__ stats;
  unsigned long long* __restrict__ amax_bits;   // (3,)
  long long* __restrict__ exps;                 // (3,) e_c

  struct Max {
    float g = 0.f, h = 0.f, l = 0.f;
  };
  __device__ static bool keep(float lv) { return lv != 0.f; }
  __device__ void put(int64_t r, float lv, Max& m) const {
    const float4 x = make_float4(__fmul_rn(grad[r], lv),
                                 __fmul_rn(hess[r], lv), lv, 0.f);
    stats[r] = x;
    m.g = fmaxf(m.g, fabsf(x.x));
    m.h = fmaxf(m.h, fabsf(x.y));
    m.l = fmaxf(m.l, fabsf(lv));
  }
  __device__ void merge(Max& m) const {
    const float g = warp_max(m.g), h = warp_max(m.h), l = warp_max(m.l);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(amax_bits, (unsigned long long)__float_as_uint(g));
      atomicMax(amax_bits + 1, (unsigned long long)__float_as_uint(h));
      atomicMax(amax_bits + 2, (unsigned long long)__float_as_uint(l));
    }
  }
  __device__ void finish_scan(int tid, int64_t n) const {
    if (tid < 3)
      exps[tid] = fixed_point_exponent(__uint_as_float((unsigned)amax_bits[tid]), n);
  }
};

// The float32 plane's rows for the sums entry (mmls_level_hist_sums): the
// same float4 per row as F32Rows, no maxima and no exponents, which the
// caller gives (taken over every rank's rows, so each rank's int64 terms
// are the one pass's).
struct F32SumRows {
  const float* __restrict__ grad;
  const float* __restrict__ hess;
  float4* __restrict__ stats;

  struct Max {};
  __device__ static bool keep(float lv) { return lv != 0.f; }
  __device__ void put(int64_t r, float lv, Max&) const {
    stats[r] = make_float4(__fmul_rn(grad[r], lv), __fmul_rn(hess[r], lv),
                           lv, 0.f);
  }
  __device__ void merge(Max&) const {}
  __device__ void finish_scan(int, int64_t) const {}
};

// The amax entry: each channel's largest |value| over the n rows, as
// F32Rows's count pass takes it (fmaxf over (grad*live, hess*live, live) of
// every row), merged by integer atomicMax on the float bits (amax_bits
// zeroed by the caller).
constexpr int kAmaxThreads = 256;

__global__ void __launch_bounds__(kAmaxThreads)
amax_kernel(const float* __restrict__ grad, const float* __restrict__ hess,
            const float* __restrict__ live,
            unsigned long long* __restrict__ amax_bits, int64_t n) {
  float g = 0.f, h = 0.f, l = 0.f;
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const float lv = live[r];
    g = fmaxf(g, fabsf(__fmul_rn(grad[r], lv)));
    h = fmaxf(h, fabsf(__fmul_rn(hess[r], lv)));
    l = fmaxf(l, fabsf(lv));
  }
  g = warp_max(g);
  h = warp_max(h);
  l = warp_max(l);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(amax_bits, (unsigned long long)__float_as_uint(g));
    atomicMax(amax_bits + 1, (unsigned long long)__float_as_uint(h));
    atomicMax(amax_bits + 2, (unsigned long long)__float_as_uint(l));
  }
}

// 2^k as a double, built from its bits (|k| <= 1022 here: e_c lies in
// [-106, 234] for any finite float data).
__device__ __forceinline__ double pow2(long long k) {
  return __longlong_as_double((k + 1023) << 52);
}

__device__ __forceinline__ long long term(float x, double up) {
  return __double2ll_rn(__dmul_rn((double)x, up));
}

// A 64-bit add into a cell held as two 32-bit words in separate planes,
// with two native 32-bit shared atomics: the low word returns its old value
// to give the carry, which goes into the high word with the term's high
// half. The words end as the exact 64-bit sum (two's complement, mod
// 2^64), in any order of the adds. (A 64-bit shared atomicAdd is a CAS
// loop on sm_90, ATOMS.CAST.SPIN.64, at about half the rate.)
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi, long long t) {
  const unsigned tl = (unsigned)t;
  const unsigned old = atomicAdd(lo, tl);
  const unsigned th = (unsigned)(t >> 32) + (old + tl < old ? 1u : 0u);
  if (th) atomicAdd(hi, th);
}

// A run of at most kChunk sorted rows [c0, c0 + rows) of one node w.
struct Chunk {
  int64_t c0;
  int rows;     // 0: the CTA's run is done
  int w;
};

// The chunk after `c`: the rest of node c.w's rows in the run, else the
// first rows of the next node that has some.
__device__ __forceinline__ Chunk next_chunk(Chunk c, int64_t p_end,
                                            const int64_t* __restrict__ offsets) {
  Chunk n{c.c0 + c.rows, 0, c.w};
  if (c.rows == 0 || n.c0 >= p_end) return n;
  while (offsets[n.w + 1] <= n.c0) ++n.w;
  n.rows = (int)min64(kChunk, min64(p_end, offsets[n.w + 1]) - n.c0);
  return n;
}

// 4. The histogram.
__global__ void __launch_bounds__(kThreads, 1)
level_hist_kernel(const uint8_t* __restrict__ binned,     // (n, f) row-major
                  const float4* __restrict__ stats,       // (n,) from plan_count
                  const int64_t* __restrict__ order,      // kept rows by node
                  const int64_t* __restrict__ offsets,    // (width + 1,)
                  const long long* __restrict__ exps,     // (3,) e_c
                  unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                  int f, int b, int width, int f_slice, int num_slices,
                  int word_bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  // cell (feature fl, bin, channel c) of the slice: low word at
  // cells[2c * plane + bin * 32 + fl], high word one plane further; a
  // warp's lanes (its features) always hit 32 different banks
  const int plane = b * kLanes;
  const int ws = (f_slice + 3) & ~3;                 // staged bytes per row
  unsigned* cells = reinterpret_cast<unsigned*>(smem);
  float4* sstats = reinterpret_cast<float4*>(cells + 6 * plane);   // [2][kChunk]
  long long* sterm = reinterpret_cast<long long*>(sstats + 2 * kChunk);  // [kChunk][4]
  uint8_t* sbin = reinterpret_cast<uint8_t*>(sterm + 4 * kChunk);  // [2][kChunk][ws]
  int64_t* srow = reinterpret_cast<int64_t*>(sbin + 2 * kChunk * ws);  // [2][kChunk]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this CTA's feature slice: slice s owns CTAs [T*s*f_slice/f, ...), a
  // share of the grid in proportion to its features
  const long long grid = gridDim.x;
  int s = 0;
  while (s + 1 < num_slices && grid * (s + 1) * f_slice / f <= blockIdx.x) ++s;
  const long long g0 = grid * s * f_slice / f;
  const long long g1 = s + 1 < num_slices ? grid * (s + 1) * f_slice / f : grid;
  const int f0 = s * f_slice;
  const int fs = f - f0 < f_slice ? f - f0 : f_slice;

  // its equal run [p, p_end) of the kept rows, sorted by node
  const int64_t kept = offsets[width];
  const int64_t p = kept * (blockIdx.x - g0) / (g1 - g0);
  const int64_t p_end = kept * (blockIdx.x - g0 + 1) / (g1 - g0);
  const double up0 = pow2(exps[0]), up1 = pow2(exps[1]), up2 = pow2(exps[2]);

  for (int i = tid; i < 6 * plane; i += kThreads) cells[i] = 0u;
  // the node of row p: the last w with offsets[w] <= p
  int w0 = 0;
  for (int hi = width; hi - w0 > 1;) {
    const int mid = (w0 + hi) >> 1;
    if (offsets[mid] <= p) w0 = mid; else hi = mid;
  }
  Chunk cur{p, 0, w0};
  if (p < p_end)
    cur.rows = (int)min64(kChunk, min64(p_end, offsets[w0 + 1]) - p);
  Chunk nxt = next_chunk(cur, p_end, offsets);

  // a chunk's (grad*live, hess*live, live) and the slice's bin bytes into
  // shared memory by cp.async: the rows' ids are in srow[buf]; a row's bin
  // words go to consecutive threads, so a warp's copies touch few sectors
  auto stage = [&](int buf, int rows) {
    const int64_t* rid = srow + buf * kChunk;
    if (tid < rows) cp_async16(sstats + buf * kChunk + tid, stats + rid[tid]);
    uint8_t* dst = sbin + buf * kChunk * ws;
    if (word_bins) {
      const int wpr = fs >> 2;
      for (int i = tid; i < rows * wpr; i += kThreads) {
        const int j = i / wpr, k = (i - j * wpr) * 4;
        cp_async4(dst + j * ws + k, binned + rid[j] * f + f0 + k);
      }
    } else {
      for (int i = tid; i < rows * fs; i += kThreads) {
        const int j = i / fs, k = i - j * fs;
        dst[j * ws + k] = binned[rid[j] * f + f0 + k];
      }
    }
  };
  if (tid < cur.rows) srow[tid] = order[cur.c0 + tid];
  if (tid < nxt.rows) srow[kChunk + tid] = order[nxt.c0 + tid];
  __syncthreads();                                   // cells are zero, ids staged
  stage(0, cur.rows);
  cp_async_commit();

  for (int buf = 0; cur.rows > 0; buf ^= 1) {
    const Chunk after = next_chunk(nxt, p_end, offsets);
    stage(buf ^ 1, nxt.rows);                        // in flight during this chunk
    cp_async_commit();
    const int64_t r_after = tid < after.rows ? order[after.c0 + tid] : 0;
    cp_async_wait<1>();                              // this chunk has landed
    __syncthreads();
    if (tid < cur.rows) {                            // the rows' terms, once
      const float4 x = sstats[buf * kChunk + tid];
      sterm[tid * 4] = term(x.x, up0);
      sterm[tid * 4 + 1] = term(x.y, up1);
      sterm[tid * 4 + 2] = term(x.z, up2);
    }
    __syncthreads();
    if (lane < fs) {
      const uint8_t* bins = sbin + buf * kChunk * ws + lane;
      for (int j = warp; j < cur.rows; j += kThreads / kLanes) {
        const int bin = bins[j * ws];
        if (bin < b) {  // out-of-range ids are the caller's bug; never write past the slice
          const longlong2 gh = reinterpret_cast<const longlong2*>(sterm)[j * 2];
          const long long tl = sterm[j * 4 + 2];
          unsigned* cell = cells + bin * kLanes + lane;
          add64(cell, cell + plane, gh.x);
          add64(cell + 2 * plane, cell + 3 * plane, gh.y);
          add64(cell + 4 * plane, cell + 5 * plane, tl);
        }
      }
    }
    if (nxt.rows == 0 || nxt.w != cur.w) {
      // the run leaves node cur.w: add its cells into the int64 sums, where
      // the slice's (fs, b, 3) cells are contiguous, and clear them
      __syncthreads();
      unsigned long long* dst = acc + ((int64_t)cur.w * f + f0) * b * 3;
      for (int i = tid; i < 3 * fs * b; i += kThreads) {
        const int c = i % 3, fl = i / 3 / b, bin = i / 3 - fl * b;
        unsigned* lo = cells + 2 * c * plane + bin * kLanes + fl;
        const unsigned long long v =
            (unsigned long long)lo[plane] << 32 | lo[0];
        if (v != 0) {
          atomicAdd(dst + i, v);
          lo[0] = lo[plane] = 0u;
        }
      }
    }
    if (tid < after.rows) srow[buf * kChunk + tid] = r_after;  // this chunk's ids are spent
    __syncthreads();
    cur = nxt;
    nxt = after;
  }
}

// 4u. The histogram on uint16 ids (see "Bin ids past 256 bins" above):
// `ids` is the (n, f) uint16 matrix read as 4-byte words; per_tile CTAs
// take each of num_tiles tiles of tile_bins bins, and the grid's CTAs take
// those per_tile * num_tiles "virtual" CTAs in turn.
__global__ void __launch_bounds__(kThreads, 1)
level_hist_u16_kernel(const unsigned* __restrict__ ids,     // (n, f) uint16
                      const float4* __restrict__ stats,     // (n,) from plan_count
                      const int64_t* __restrict__ order,    // kept rows by node
                      const int64_t* __restrict__ offsets,  // (width + 1,)
                      const long long* __restrict__ exps,   // (3,) e_c
                      unsigned long long* __restrict__ acc, // (width, f, b, 3)
                      int f, int b, int width, int f_slice, int num_slices,
                      int tile_bins, int num_tiles, int per_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  // cell (feature fl, bin) of word q at cells[q * plane + U16Cells.at(fl, bin)]
  const int plane = u16_plane_words(f_slice, tile_bins);
  const int words = u16_words(f, f_slice);           // staged words per row
  unsigned* cells = reinterpret_cast<unsigned*>(smem);
  float4* sstats = reinterpret_cast<float4*>(cells + 6 * plane);   // [2][kChunk]
  // the rows' terms, then the parity of the row's first id
  long long* sterm = reinterpret_cast<long long*>(sstats + 2 * kChunk);  // [kChunk][4]
  unsigned* sbin = reinterpret_cast<unsigned*>(sterm + 4 * kChunk);  // [2][kChunk][words]
  int64_t* srow = reinterpret_cast<int64_t*>(sbin + 2 * kChunk * words);  // [2][kChunk]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t kept = offsets[width];
  const double up0 = pow2(exps[0]), up1 = pow2(exps[1]), up2 = pow2(exps[2]);

  for (int i = tid; i < 6 * plane; i += kThreads) cells[i] = 0u;
  for (int v = blockIdx.x; v < per_tile * num_tiles; v += gridDim.x) {
    // virtual CTA v: CTA x of tile t, whose bins are [t0, t0 + bt)
    const int t = v / per_tile, x = v - t * per_tile;
    const int t0 = t * tile_bins;
    const int bt = b - t0 < tile_bins ? b - t0 : tile_bins;
    // its feature slice: slice s owns the tile's CTAs [per_tile*s*f_slice/f,
    // ...), a share in proportion to its features
    int s = 0;
    while (s + 1 < num_slices && (int64_t)per_tile * (s + 1) * f_slice / f <= x) ++s;
    const int64_t g0 = (int64_t)per_tile * s * f_slice / f;
    const int64_t g1 = s + 1 < num_slices ? (int64_t)per_tile * (s + 1) * f_slice / f
                                          : per_tile;
    const int f0 = s * f_slice;
    const int fs = f - f0 < f_slice ? f - f0 : f_slice;
    // a warp adds rpw rows at once: lane = k * fs + fl adds feature fl of
    // the group's row k; lanes past rpw * fs idle
    const int rpw = kLanes / fs;
    const int k = lane / fs, fl = lane - k * fs;
    const U16Cells where(fs, tile_bins);

    // its equal run [p, p_end) of the kept rows, sorted by node
    const int64_t p = kept * (x - g0) / (g1 - g0);
    const int64_t p_end = kept * (x - g0 + 1) / (g1 - g0);
    int w0 = 0;                                      // the node of row p
    for (int hi = width; hi - w0 > 1;) {
      const int mid = (w0 + hi) >> 1;
      if (offsets[mid] <= p) w0 = mid; else hi = mid;
    }
    Chunk cur{p, 0, w0};
    if (p < p_end)
      cur.rows = (int)min64(kChunk, min64(p_end, offsets[w0 + 1]) - p);
    Chunk nxt = next_chunk(cur, p_end, offsets);

    // a chunk's stats and the words covering the slice's ids of each row
    // into shared memory by cp.async; the rows' ids are in srow[buf]
    auto stage = [&](int buf, int rows) {
      const int64_t* rid = srow + buf * kChunk;
      if (tid < rows) cp_async16(sstats + buf * kChunk + tid, stats + rid[tid]);
      unsigned* dst = sbin + buf * kChunk * words;
      for (int i = tid; i < rows * words; i += kThreads) {
        const int j = i / words, q = i - j * words;
        stage_u16_word(dst + j * words, ids, rid[j] * f + f0, fs, q);
      }
    };
    if (tid < cur.rows) srow[tid] = order[cur.c0 + tid];
    if (tid < nxt.rows) srow[kChunk + tid] = order[nxt.c0 + tid];
    __syncthreads();                                 // cells are zero, ids staged
    stage(0, cur.rows);
    cp_async_commit();

    for (int buf = 0; cur.rows > 0; buf ^= 1) {
      const Chunk after = next_chunk(nxt, p_end, offsets);
      stage(buf ^ 1, nxt.rows);                      // in flight during this chunk
      cp_async_commit();
      const int64_t r_after = tid < after.rows ? order[after.c0 + tid] : 0;
      cp_async_wait<1>();                            // this chunk has landed
      __syncthreads();
      if (tid < cur.rows) {                          // the rows' terms, once per slice
        const float4 st = sstats[buf * kChunk + tid];
        sterm[tid * 4] = term(st.x, up0);
        sterm[tid * 4 + 1] = term(st.y, up1);
        sterm[tid * 4 + 2] = term(st.z, up2);
        // the parity of the row's first id: which half of its first word
        sterm[tid * 4 + 3] = (((int)srow[buf * kChunk + tid] & f) ^ f0) & 1;
      }
      __syncthreads();
      if (k < rpw) {
        const uint16_t* bins = reinterpret_cast<const uint16_t*>(
            sbin + buf * kChunk * words);
        for (int j = warp * rpw + k; j < cur.rows; j += kThreads / kLanes * rpw) {
          const longlong2 gh = reinterpret_cast<const longlong2*>(sterm)[j * 2];
          const longlong2 lh = reinterpret_cast<const longlong2*>(sterm)[j * 2 + 1];
          const int bin = (int)bins[j * 2 * words + (int)lh.y + fl] - t0;
          // a bin of another tile; out-of-range ids are the caller's bug:
          // never write past the slice
          if ((unsigned)bin < (unsigned)bt) {
            unsigned* cell = cells + where.at(fl, bin);
            add64(cell, cell + plane, gh.x);
            add64(cell + 2 * plane, cell + 3 * plane, gh.y);
            add64(cell + 4 * plane, cell + 5 * plane, lh.x);
          }
        }
      }
      if (nxt.rows == 0 || nxt.w != cur.w) {
        // the run leaves node cur.w: add its cells into the int64 sums and
        // clear them; the slice's (fs, b, 3) sums are contiguous, and a
        // tile's (bt, 3) run of each feature's
        __syncthreads();
        unsigned long long* dst = acc + (((int64_t)cur.w * f + f0) * b + t0) * 3;
        for (int i = tid; i < 3 * fs * bt; i += kThreads) {
          const int c = i % 3, cf = i / 3 / bt, bin = i / 3 - cf * bt;
          unsigned* lo = cells + 2 * c * plane + where.at(cf, bin);
          const unsigned long long sum =
              (unsigned long long)lo[plane] << 32 | lo[0];
          if (sum != 0) {
            atomicAdd(dst + ((int64_t)cf * b + bin) * 3 + c, sum);
            lo[0] = lo[plane] = 0u;
          }
        }
      }
      if (tid < after.rows) srow[buf * kChunk + tid] = r_after;  // this chunk's ids are spent
      __syncthreads();
      cur = nxt;
      nxt = after;
    }
  }
}

// 4i. The histogram on int32 ids (see "Bin ids past 65,536 bins" above):
// level_hist_common.cuh's hist_i32_kernel over this plane's terms, the
// float4 of the row at place p of the node order (gathered from the
// partition's count pass) scaled and rounded by e_c.
struct F32Terms {
  const float4* __restrict__ stats;    // (kept,) in node order
  const long long* __restrict__ exps;  // (3,) e_c
  double up0, up1, up2;
  using Stat = float4;
  __device__ F32Terms ready() const {
    F32Terms t = *this;
    t.up0 = pow2(exps[0]);
    t.up1 = pow2(exps[1]);
    t.up2 = pow2(exps[2]);
    return t;
  }
  __device__ float4 load(int64_t p) const { return __ldg(stats + p); }
  __device__ void add(const float4& x, long long& s0, long long& s1,
                      long long& s2) const {
    s0 += term(x.x, up0);
    s1 += term(x.y, up1);
    s2 += term(x.z, up2);
  }
};

// The dequantization's scales: 2^-e_c.
struct InversePow2 {
  const long long* exps;
  __device__ double operator()(int c) const { return pow2(-exps[c]); }
};

// The histogram launch: uint8 ids over one tile of every bin (tile_bins =
// b), uint16 ids over num_tiles tiles of tile_bins bins, which must start
// on a 4-byte boundary (their rows are staged as the words that cover
// them). The grid is hist_grid's.
cudaError_t launch_hist(const void* binned, const void* stats,
                        const void* order, const void* offsets,
                        const long long* exps, unsigned long long* sums,
                        int f, int b, int width, int f_slice, int num_slices,
                        int bin_bytes, int tile_bins, int num_tiles, int smem,
                        int device, cudaStream_t s) {
  HistGrid g;
  cudaError_t err;
  if (bin_bytes == 1) {
    if (num_tiles != 1 || tile_bins != b) return cudaErrorInvalidValue;
    err = hist_grid(level_hist_kernel, kThreads, smem, 1, num_slices, 1,
                    device, &g);
    if (err != cudaSuccess) return err;
    const int word_bins = f % 4 == 0 && f_slice % 4 == 0 &&
                          (uintptr_t)binned % 4 == 0;
    level_hist_kernel<<<g.ctas, kThreads, smem, s>>>(
        (const uint8_t*)binned, (const float4*)stats, (const int64_t*)order,
        (const int64_t*)offsets, exps, sums, f, b, width, f_slice, num_slices,
        word_bins);
    return cudaGetLastError();
  }
  if (bin_bytes != 2 || (uintptr_t)binned % 4 != 0 || f_slice < 1 ||
      f_slice > kLanes || tile_bins < 1 || (int64_t)tile_bins * num_tiles < b)
    return cudaErrorInvalidValue;
  err = hist_grid(level_hist_u16_kernel, kThreads, smem, 2, num_slices,
                  num_tiles, device, &g);
  if (err != cudaSuccess) return err;
  level_hist_u16_kernel<<<g.ctas, kThreads, smem, s>>>(
      (const unsigned*)binned, (const float4*)stats, (const int64_t*)order,
      (const int64_t*)offsets, exps, sums, f, b, width, f_slice, num_slices,
      tile_bins, num_tiles, g.per_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the partition (three kernels), the histogram and the dequantization
// on `stream` (a cudaStream_t) of device `device`. `binned` holds uint8
// (bin_bytes 1), uint16 (2, from a 4-byte boundary) or int32 (4) ids; `local`
// int32 (local_bytes 4) or int64 (8) node ids. Scratch, written here: `stats`
// (n, 4) float32; `counts` (width + 1) * (ns + nb) int32 for ns = ceil(n /
// 512) warp segments and nb = ceil(ns / 8) CTAs (the per-warp counts, then the
// per-CTA places); `offsets` width + 1 int64; `order` n int64; `wide`, for
// int32 ids only (else null), hist_cuda.i32_scratch_bytes(n, f, 16) bytes from
// a 16-byte boundary (I32Scratch: the items' counter, the node-ordered float4
// stats, the (f, n) int32 columns, their tile keys). `acc` holds width * f * b * 3 int64 sums
// (none for int32 ids, whose sums stay in shared memory) and then 6 int64 (the
// channels' amax bits, then e_c), all zero on entry; `out` is the (width, f,
// b, 3) float32 histogram; the bins go in num_tiles tiles of tile_bins (uint8
// ids: one tile, tile_bins = b); `smem` a histogram CTA's dynamic shared
// memory (hist_cuda.f32_smem_bytes / f32_u16_smem_bytes / i32_smem_bytes).
// width must be below 12288 (the partition's per-warp key counters). Returns
// the first CUDA error: 0 on success.
int mmls_level_hist(const void* binned, const void* grad, const void* hess,
                    const void* live, const void* local, int local_bytes,
                    void* stats, void* counts, void* offsets, void* order,
                    void* wide, void* acc, void* out, long long n, int f,
                    int b, int width, int f_slice, int num_slices,
                    int bin_bytes, int tile_bins, int num_tiles, int smem,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool i32 = bin_bytes == 4;
  if ((bin_bytes != 1 && bin_bytes != 2 && !i32) || i32 != (wide != nullptr) ||
      (i32 && (smem != i32_smem(tile_bins) ||
               !i32_tiles_ok(b, tile_bins, num_tiles))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t cells = i32 ? 0 : (int64_t)width * f * b * 3;
  unsigned long long* sums = (unsigned long long*)acc;
  unsigned long long* amax_bits = sums + cells;
  long long* exps = (long long*)(sums + cells + 3);
  int* wcounts = (int*)counts;
  int* btot = wcounts + plan_wcounts(n, width);
  const F32Rows rows{(const float*)grad, (const float*)hess, (float4*)stats,
                     amax_bits, exps};

  if (local_bytes == 8)
    err = plan((const int64_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else if (local_bytes == 4)
    err = plan((const int32_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  if (i32) {
    const I32Scratch<float4> w(wide, n, f);
    err = gather_i32(binned, (const float4*)stats, (const int64_t*)order,
                     (const int64_t*)offsets, w, n, f, width, tile_bins, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_i32(
        w, F32Terms{w.nstats, exps},
        DequantOut<InversePow2>{(float*)out, InversePow2{exps}},
        (const int64_t*)offsets, n, f, b, width, tile_bins, num_tiles, device,
        s);
  }
  err = launch_hist(binned, stats, order, offsets, exps, sums, f, b, width,
                    f_slice, num_slices, bin_bytes, tile_bins, num_tiles, smem,
                    device, s);
  if (err != cudaSuccess) return (int)err;
  return (int)level_hist::dequantize((const long long*)sums, (float*)out,
                                     InversePow2{exps}, cells, s);
}

// The sums entry's first call: the channels' amax over the n rows, as
// float bits into amax_bits (3 uint64, zero on entry), on `stream` of
// `device`. Returns the first CUDA error: 0 on success.
int mmls_level_hist_amax(const void* grad, const void* hess, const void* live,
                         void* amax_bits, long long n, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const long long want = (n + kAmaxThreads * 8 - 1) / (kAmaxThreads * 8);
  const int blocks = (int)(want < 4096 ? want : 4096);
  amax_kernel<<<blocks, kAmaxThreads, 0, (cudaStream_t)stream>>>(
      (const float*)grad, (const float*)hess, (const float*)live,
      (unsigned long long*)amax_bits, n);
  return (int)cudaGetLastError();
}

// The sums entry: mmls_level_hist's partition and histogram under the
// caller's exponents `exps` (3 int64 e_c on the device, from the amax of
// every rank's rows and their row count), adding the int64 sums into the
// caller's (width, f, b, 3) `acc` with no rounding: the sums of any split
// of the rows add up to the one pass's, bit for bit. On int32 ids the
// items add their tiles' nonzero cells into `acc` (each item owns its
// cells). The other arguments are mmls_level_hist's (no `out`, no amax or
// exponent scratch). Returns the first CUDA error: 0 on success.
int mmls_level_hist_sums(const void* binned, const void* grad,
                         const void* hess, const void* live,
                         const void* local, int local_bytes, void* stats,
                         void* counts, void* offsets, void* order, void* wide,
                         const void* exps, void* acc, long long n, int f,
                         int b, int width, int f_slice, int num_slices,
                         int bin_bytes, int tile_bins, int num_tiles,
                         int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool i32 = bin_bytes == 4;
  if ((bin_bytes != 1 && bin_bytes != 2 && !i32) || i32 != (wide != nullptr) ||
      acc == nullptr || exps == nullptr ||
      (i32 && (smem != i32_smem(tile_bins) ||
               !i32_tiles_ok(b, tile_bins, num_tiles))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* wcounts = (int*)counts;
  int* btot = wcounts + plan_wcounts(n, width);
  const F32SumRows rows{(const float*)grad, (const float*)hess,
                        (float4*)stats};
  if (local_bytes == 8)
    err = plan((const int64_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else if (local_bytes == 4)
    err = plan((const int32_t*)local, (const float*)live, rows, wcounts, btot,
               (int64_t*)offsets, (int64_t*)order, n, width, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const long long* e = (const long long*)exps;
  if (i32) {
    const I32Scratch<float4> w(wide, n, f);
    err = gather_i32(binned, (const float4*)stats, (const int64_t*)order,
                     (const int64_t*)offsets, w, n, f, width, tile_bins, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_i32(w, F32Terms{w.nstats, e}, MergeOut{(long long*)acc},
                           (const int64_t*)offsets, n, f, b, width, tile_bins,
                           num_tiles, device, s);
  }
  return (int)launch_hist(binned, stats, order, offsets, e,
                          (unsigned long long*)acc, f, b, width, f_slice,
                          num_slices, bin_bytes, tile_bins, num_tiles, smem,
                          device, s);
}

// The rounding entry: out[i] = float(double(acc[i]) * 2^-e_c) over `cells`
// int64 sums (c = i % 3), the expression mmls_level_hist ends with. Returns
// the first CUDA error: 0 on success.
int mmls_level_hist_round(const void* acc, const void* exps, void* out,
                          long long cells, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cells <= 0) return 0;
  return (int)level_hist::dequantize(
      (const long long*)acc, (float*)out,
      InversePow2{(const long long*)exps}, cells, (cudaStream_t)stream);
}

// The histogram launch's grid on `device` at these arguments of
// mmls_level_hist: out[0..3] = SMs, CTAs per SM, CTAs launched, CTAs per
// tile of bins (hist_cuda.launch_geometry). Returns the first CUDA error.
int mmls_level_hist_grid(int bin_bytes, int smem, int num_slices,
                         int num_tiles, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HistGrid g;
  err = bin_bytes == 1
      ? hist_grid(level_hist_kernel, kThreads, smem, 1, num_slices, num_tiles,
                  device, &g)
      : bin_bytes == 4
      ? hist_grid(hist_i32_kernel<F32Terms, DequantOut<InversePow2>>,
                  kI32Threads, smem, 4, num_slices, num_tiles, device, &g)
      : hist_grid(level_hist_u16_kernel, kThreads, smem, 2, num_slices,
                  num_tiles, device, &g);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.sms;
  out[1] = g.per_sm;
  out[2] = g.ctas;
  out[3] = g.per_tile;
  return 0;
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

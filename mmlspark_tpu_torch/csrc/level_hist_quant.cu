// Quantized per-level GBDT histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel mmlspark_tpu/models/gbdt/hist_pallas.py:_hist_kernel
// as driven by pallas_level_histogram_quant (hist_pallas.py:204), the entry
// the JAX trainer takes under MMLSPARK_TPU_HIST_QUANT=q16|q8. It computes what
// the JAX package's native merge defines (native/data_plane.cpp, the
// mmls_level_hist_q16/_q8 kernels): for int16 or int8 grad/hess under shared
// power-of-two scales, a (width, F, B, 3) float32 histogram whose cell
// (node, f, bin) holds float32(sum(grad_q) * double(gscale_inv)),
// float32(sum(hess_q) * double(hscale_inv)) and the row count, over the rows
// of `node` with live > 0 whose feature f falls in `bin`. Sums are exact
// integers, rounded to float32 once; integer adds commute, so the result is
// the same bits whatever order the rows are added in, and the fit on this
// kernel is reproducible run to run.
//
// Design. Five launches on the stream, none waiting on the host:
//   1-3. the stable counting partition by node of level_hist_common.cuh,
//      shared with level_hist.cu; this plane keeps the rows with live > 0
//      (QuantRows), and its count pass writes each row's grad_q and hess_q
//      as one packed 32-bit word (two int16 halves; int8 widened), so the
//      histogram gathers one 4-byte word per row;
//   4. the histogram, on level_hist.cu's walk. The grid is persistent
//      (kCtasPerSm CTAs per SM, by the occupancy API), the CTAs split over
//      feature slices of at most 32 features in proportion to their
//      features. Each CTA takes an equal run of the sorted kept rows and
//      stages it in chunks of kChunk rows through a ring of kStages buffers:
//      while it adds one chunk, cp.async gathers the packed words and the
//      slice's bin bytes (32-bit copies where rows are whole words) of the
//      chunks after it. One warp adds a row, a lane per feature, into the
//      CTA's int32 cells, one native 32-bit shared atomic per channel; the
//      cells of channel c sit at c * plane + bin * 32 + lane, so the 32
//      lanes of a warp always hit 32 different banks (97,920 B at B = 255,
//      half the float32 kernel's int64 cells). Where the run leaves a node
//      the CTA adds its non-zero cells, sign-extended, into the zeroed int64
//      sums with 64-bit global atomics (two's-complement adds give the exact
//      signed sum in any order) and clears them;
//   5. the elementwise dequantization (level_hist_common.cuh); in the JAX
//      package too it lies outside the Pallas body (hist_pallas.py:218-219).
//
// Chunk merges (out-of-core training, models/gbdt/ooc.py). Launches 1-4 add
// a chunk of rows into the caller's running int64 sums when `out` is null,
// and the dequantization runs once per level over the merged sums
// (mmls_level_hist_quant_dequantize), with the expression of launch 5: the
// same device code as one pass over all the rows, so the merged histogram
// is that pass's, bit for bit. The JAX package merges chunks on the host,
// in float64 (models/gbdt/ooc.py:210-244); here the sums never leave the
// card.
//
// Bin ids past 256 bins: uint16 ids (B <= 65,536) take a kernel of their
// own, level_hist_quant_u16_kernel, on level_hist.cu's plan for them (see
// "Bin ids past 256 bins" there): each (row, feature) pair is added by
// exactly one CTA. The slices are as narrow as the cells of every bin need
// (hist_cuda.quant_plan: 12 features at B = 1,023, 20 at 511, 4 at 4,095),
// the int32 cells hold only the slice's features, channel c of (feature
// fl, bin) at cells[c * plane + U16Cells.at(fl, bin)] (feature fl owns
// g = floor(32 / fs) banks); a warp adds g rows at once, a lane per (row,
// feature), each feature's g lanes on its own g banks; a
// row's packed word and row id are staged once per slice and its ids once
// in all, as the 4-byte words that cover them, with the row's parity (the
// half its first id starts at) in a byte beside them. Tiles of bins remain
// only past one feature's limit (about 17,000 bins). The window, the
// flushes and the one wave are as above.
//
// Bin ids past 65,536 bins: int32 ids take level_hist_common.cuh's int32
// histogram after the partition (its scatter too): the kept rows' ids
// gathered into node-ordered columns with their packed words beside them,
// each CTA item one (node, feature, tile of bins) whose int64 cells sit in
// shared memory, its quanta and counts added there (a run of one cell
// merged in registers first). The one-pass entry dequantizes each tile
// into `out` in its epilogue, with launch 5's expression (no int64 plane,
// no separate pass); the chunk-merge entry (`out` null) adds each tile's
// nonzero sums into the caller's running int64 sums, which the item owns.
// The int32 cells and their window (below) do not apply there.
//
// The int32 window. A cell grows by at most 2^(bits-1) per row, so it holds
// W = floor((2^31 - 1) / 2^(bits-1)) rows (q16: 65,535; q8: 16,777,215)
// without wrapping. A CTA's run in one node is not bounded by a tile (at
// N = 2M about 14k rows, but it grows with N), so the CTA also flushes once
// a node's rows since its last flush could pass W with one more chunk
// (`window`, hist_cuda.quant_window): the part the native kernel's periodic
// flush plays.
//
// What bounds it. Per level the function must read the N x F bin bytes, the
// two (N,) int16/int8 vectors, the (N,) float32 live mask and the (N,) node
// ids (int64 on the training path), and write the (width, F, B, 3) float32
// histogram: at N = 2M, F = 28 about 84-88 MB, some 26 us at the H100 SXM's
// 3.35 TB/s. The adds (3 per live row and feature) are far below the card's
// integer rate, so the bound is bytes. Over it: the partition reads the node
// ids and live twice; below the root a node's rows sit at scattered
// addresses, so a row costs a 32-byte sector of packed words and one or two
// of bin bytes; three 32-bit shared atomics per (row, feature) and the
// latency of the staging set the histogram's pace.

#include <cstdint>
#include <cuda_runtime.h>

#include "level_hist_common.cuh"

namespace {

using namespace level_hist;

// The launch configuration, measured by tools/torch_hist_quant_configs.py:
// 1,024-row chunks pay fewer barriers per row than 256 or 512 (larger ones
// lose more to filling and draining the ring below the root); a deeper
// ring, or two CTAs of 512 threads per SM in the shared memory the int32
// cells leave free, were no faster.
constexpr int kThreads = 1024;
constexpr int kCtasPerSm = 1;
constexpr int kChunk = 1024;         // rows staged at once (hist_cuda.QUANT_CHUNK_ROWS)
constexpr int kStages = 2;           // chunks in the ring (hist_cuda.QUANT_STAGES)
constexpr int kLanes = 32;           // a warp per row, a lane per feature
constexpr int kWarps = kThreads / kLanes;
constexpr int kIds = (kChunk + kThreads - 1) / kThreads;  // row ids a thread loads ahead

// The quantized plane's rows for the partition: it keeps live > 0 (the gate
// of its plain version, hist_cuda.level_histogram_quant_reference), and the
// count pass packs each row's grad_q (low half) and hess_q (high half).
template <typename Q>
struct QuantRows {
  const Q* __restrict__ grad;
  const Q* __restrict__ hess;
  unsigned* __restrict__ packed;                // (n,)

  struct Max {};
  __device__ static bool keep(float lv) { return lv > 0.f; }
  __device__ void put(int64_t r, float, Max&) const {
    packed[r] = (unsigned)(uint16_t)(int16_t)grad[r] |
                (unsigned)(uint16_t)(int16_t)hess[r] << 16;
  }
  __device__ void merge(Max&) const {}
  __device__ void finish_scan(int, int64_t) const {}
};

// The packed word's halves, sign-extended to int32.
__device__ __forceinline__ int low_half(unsigned x) { return (int)(x << 16) >> 16; }
__device__ __forceinline__ int high_half(unsigned x) { return (int)x >> 16; }

// 4. The histogram.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
level_hist_quant_kernel(const uint8_t* __restrict__ binned,     // (n, f) row-major
                        const unsigned* __restrict__ stats,     // (n,) packed
                        const int64_t* __restrict__ order,      // kept rows by node
                        const int64_t* __restrict__ offsets,    // (width + 1,)
                        unsigned long long* __restrict__ acc,   // (width, f, b, 3)
                        int f, int b, int width, int f_slice, int num_slices,
                        int word_bins, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int plane = b * kLanes;
  const int ws = (f_slice + 3) & ~3;                 // staged bytes per row
  int* cells = reinterpret_cast<int*>(smem);         // [3][b][32]
  unsigned* sstats = reinterpret_cast<unsigned*>(cells + 3 * plane);  // [kStages][kChunk]
  int* srow = reinterpret_cast<int*>(sstats + kStages * kChunk);      // [kStages][kChunk]
  uint8_t* sbin = reinterpret_cast<uint8_t*>(srow + kStages * kChunk);  // [kStages][kChunk][ws]
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

  // its equal run [p, p_end) of the kept rows, sorted by node; chunk i
  // holds the sorted positions [p + i * kChunk, ...)
  const int64_t kept = offsets[width];
  const int64_t p = kept * (blockIdx.x - g0) / (g1 - g0);
  const int64_t p_end = kept * (blockIdx.x - g0 + 1) / (g1 - g0);
  auto rows_of = [&](int64_t i) -> int {
    const int64_t left = p_end - (p + i * kChunk);
    return left <= 0 ? 0 : (int)min64(kChunk, left);
  };

  for (int i = tid; i < 3 * plane; i += kThreads) cells[i] = 0;

  // a chunk's packed words and the slice's bin bytes into ring slot `slot`
  // by cp.async; the rows' ids are in srow[slot]; a row's bin words go to
  // consecutive threads, so a warp's copies touch few sectors
  auto stage = [&](int slot, int rows) {
    const int* rid = srow + slot * kChunk;
    for (int j = tid; j < rows; j += kThreads)
      cp_async4(sstats + slot * kChunk + j, stats + rid[j]);
    uint8_t* dst = sbin + slot * kChunk * ws;
    if (word_bins) {
      const int wpr = fs >> 2;
      for (int i = tid; i < rows * wpr; i += kThreads) {
        const int j = i / wpr, k = (i - j * wpr) * 4;
        cp_async4(dst + j * ws + k, binned + (int64_t)rid[j] * f + f0 + k);
      }
    } else {
      for (int i = tid; i < rows * fs; i += kThreads) {
        const int j = i / fs, k = i - j * fs;
        dst[j * ws + k] = binned[(int64_t)rid[j] * f + f0 + k];
      }
    }
  };

  // add the int32 cells into node w's int64 sums, where the slice's
  // (fs, b, 3) cells are contiguous, and clear them
  auto flush = [&](int w) {
    __syncthreads();                                 // every add has landed
    unsigned long long* dst = acc + ((int64_t)w * f + f0) * b * 3;
    for (int i = tid; i < 3 * fs * b; i += kThreads) {
      const int c = i % 3, fl = i / 3 / b, bin = i / 3 - fl * b;
      int* cell = cells + c * plane + bin * kLanes + fl;
      const int v = *cell;
      if (v != 0) {
        atomicAdd(dst + i, (unsigned long long)(long long)v);
        *cell = 0;
      }
    }
    __syncthreads();                                 // cleared before the next adds
  };

  for (int k = 0; k < kStages; ++k)                  // the first chunks' ids
    for (int j = tid; j < rows_of(k); j += kThreads)
      srow[k * kChunk + j] = (int)order[p + k * kChunk + j];
  __syncthreads();                                   // cells are zero, ids staged
  for (int k = 0; k + 1 < kStages; ++k) {
    stage(k, rows_of(k));
    cp_async_commit();
  }

  // the node of row p: the last w with offsets[w] <= p
  int w = 0;
  for (int hi = width; hi - w > 1;) {
    const int mid = (w + hi) >> 1;
    if (offsets[mid] <= p) w = mid; else hi = mid;
  }
  int since = 0;                                     // rows of node w in the cells
  int slot = 0;                                      // chunk i's ring slot
  for (int64_t i = 0;; ++i) {
    const int rows = rows_of(i);
    if (rows == 0) break;
    stage(slot == 0 ? kStages - 1 : slot - 1, rows_of(i + kStages - 1));
    cp_async_commit();                               // in flight during this chunk
    const int rows_ahead = rows_of(i + kStages);     // its ids, into registers
    const int64_t ahead = p + (i + kStages) * kChunk;
    int id_ahead[kIds];
#pragma unroll
    for (int k = 0; k < kIds; ++k) {
      const int j = tid + k * kThreads;
      id_ahead[k] = j < rows_ahead ? (int)order[ahead + j] : 0;
    }
    cp_async_wait<kStages - 1>();                    // this chunk has landed
    __syncthreads();

    const uint8_t* bins = sbin + slot * kChunk * ws + lane;
    const unsigned* words = sstats + slot * kChunk;
    const int64_t c0 = p + i * kChunk, c1 = c0 + rows;
    for (int64_t pos = c0; pos < c1;) {              // the chunk node by node
      while (offsets[w + 1] <= pos) ++w;
      const int64_t node_end = offsets[w + 1];
      const int64_t seg_end = min64(c1, node_end);
      const int j1 = (int)(seg_end - c0);
      if (lane < fs) {
        for (int j = (int)(pos - c0) + warp; j < j1; j += kWarps) {
          const int bin = bins[j * ws];
          if (bin < b) {  // out-of-range ids are the caller's bug; never write past the slice
            const unsigned x = words[j];
            int* cell = cells + bin * kLanes + lane;
            atomicAdd(cell, low_half(x));
            atomicAdd(cell + plane, high_half(x));
            atomicAdd(cell + 2 * plane, 1);
          }
        }
      }
      since += (int)(seg_end - pos);
      pos = seg_end;
      // the run leaves node w, or one more chunk could pass the window
      if (pos == node_end || pos == p_end || since > window - kChunk) {
        flush(w);
        since = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kIds; ++k) {                 // this slot is spent
      const int j = tid + k * kThreads;
      if (j < rows_ahead) srow[slot * kChunk + j] = id_ahead[k];
    }
    __syncthreads();
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}

template <typename Q>
cudaError_t plan_quant(const void* local, int local_bytes, const void* live,
                       const void* grad, const void* hess, unsigned* packed,
                       int* wcounts, int* btot, int64_t* offsets,
                       int64_t* order, int64_t n, int width, cudaStream_t s) {
  const QuantRows<Q> rows{(const Q*)grad, (const Q*)hess, packed};
  if (local_bytes == 8)
    return plan((const int64_t*)local, (const float*)live, rows, wcounts, btot,
                offsets, order, n, width, s);
  if (local_bytes == 4)
    return plan((const int32_t*)local, (const float*)live, rows, wcounts, btot,
                offsets, order, n, width, s);
  return cudaErrorInvalidValue;
}

// 4i. The histogram on int32 ids (see "Bin ids past 65,536 bins" above):
// level_hist_common.cuh's hist_i32_kernel over this plane's terms, the
// quanta of the row at place p of the node order (its packed word,
// gathered from the partition's count pass) and a count of 1.
struct QuantTerms {
  const unsigned* __restrict__ packed;   // (kept,) in node order
  using Stat = unsigned;
  __device__ QuantTerms ready() const { return *this; }
  __device__ unsigned load(int64_t p) const { return __ldg(packed + p); }
  __device__ void add(unsigned x, long long& s0, long long& s1,
                      long long& s2) const {
    s0 += low_half(x);
    s1 += high_half(x);
    s2 += 1;
  }
};

// 4u. The histogram on uint16 ids (see "Bin ids past 256 bins" above):
// `ids` is the (n, f) uint16 matrix read as 4-byte words; per_tile CTAs
// take each of num_tiles tiles of tile_bins bins, and the grid's CTAs take
// those per_tile * num_tiles "virtual" CTAs in turn.
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
level_hist_quant_u16_kernel(const unsigned* __restrict__ ids,     // (n, f) uint16
                            const unsigned* __restrict__ stats,   // (n,) packed
                            const int64_t* __restrict__ order,    // kept rows by node
                            const int64_t* __restrict__ offsets,  // (width + 1,)
                            unsigned long long* __restrict__ acc, // (width, f, b, 3)
                            int f, int b, int width, int f_slice, int num_slices,
                            int window, int tile_bins, int num_tiles,
                            int per_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  // channel c of (feature fl, bin) at cells[c * plane + U16Cells.at(fl, bin)]
  const int plane = u16_plane_words(f_slice, tile_bins);
  const int words = u16_words(f, f_slice);           // staged words per row
  int* cells = reinterpret_cast<int*>(smem);         // [3][plane]
  unsigned* sstats = reinterpret_cast<unsigned*>(cells + 3 * plane);  // [kStages][kChunk]
  int* srow = reinterpret_cast<int*>(sstats + kStages * kChunk);      // [kStages][kChunk]
  unsigned* sbin = reinterpret_cast<unsigned*>(srow + kStages * kChunk);  // [kStages][kChunk][words]
  // the parity of each row's first id: which half of its first word
  uint8_t* sodd = reinterpret_cast<uint8_t*>(sbin + kStages * kChunk * words);  // [kStages][kChunk]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t kept = offsets[width];

  for (int i = tid; i < 3 * plane; i += kThreads) cells[i] = 0;
  for (int v = blockIdx.x; v < per_tile * num_tiles; v += gridDim.x) {
    // virtual CTA v: CTA x of tile t, whose bins are [t0, t0 + bt)
    const int t = v / per_tile, x = v - t * per_tile;
    const int t0 = t * tile_bins;
    const int bt = b - t0 < tile_bins ? b - t0 : tile_bins;
    // its feature slice, a share of the tile's CTAs in proportion to its
    // features
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

    // its equal run [p, p_end) of the kept rows, sorted by node; chunk i
    // holds the sorted positions [p + i * kChunk, ...)
    const int64_t p = kept * (x - g0) / (g1 - g0);
    const int64_t p_end = kept * (x - g0 + 1) / (g1 - g0);
    auto rows_of = [&](int64_t i) -> int {
      const int64_t left = p_end - (p + i * kChunk);
      return left <= 0 ? 0 : (int)min64(kChunk, left);
    };

    // a chunk's packed words, the rows' parities and the words covering
    // the slice's ids of each row into ring slot `slot` by cp.async; the
    // rows' ids are in srow[slot]
    auto stage = [&](int slot, int rows) {
      const int* rid = srow + slot * kChunk;
      for (int j = tid; j < rows; j += kThreads) {
        cp_async4(sstats + slot * kChunk + j, stats + rid[j]);
        sodd[slot * kChunk + j] = (uint8_t)(((rid[j] & f) ^ f0) & 1);
      }
      unsigned* dst = sbin + slot * kChunk * words;
      for (int i = tid; i < rows * words; i += kThreads) {
        const int j = i / words, q = i - j * words;
        stage_u16_word(dst + j * words, ids, (int64_t)rid[j] * f + f0, fs, q);
      }
    };

    // add the int32 cells into node w's int64 sums and clear them; the
    // slice's (fs, b, 3) sums are contiguous, and a tile's (bt, 3) run of
    // each feature's
    auto flush = [&](int w) {
      __syncthreads();                               // every add has landed
      unsigned long long* dst = acc + (((int64_t)w * f + f0) * b + t0) * 3;
      for (int i = tid; i < 3 * fs * bt; i += kThreads) {
        const int c = i % 3, cf = i / 3 / bt, bin = i / 3 - cf * bt;
        int* cell = cells + c * plane + where.at(cf, bin);
        const int sum = *cell;
        if (sum != 0) {
          atomicAdd(dst + ((int64_t)cf * b + bin) * 3 + c,
                    (unsigned long long)(long long)sum);
          *cell = 0;
        }
      }
      __syncthreads();                               // cleared before the next adds
    };

    for (int q = 0; q < kStages; ++q)                // the first chunks' ids
      for (int j = tid; j < rows_of(q); j += kThreads)
        srow[q * kChunk + j] = (int)order[p + q * kChunk + j];
    __syncthreads();                                 // cells are zero, ids staged
    for (int q = 0; q + 1 < kStages; ++q) {
      stage(q, rows_of(q));
      cp_async_commit();
    }

    // the node of row p: the last w with offsets[w] <= p
    int w = 0;
    for (int hi = width; hi - w > 1;) {
      const int mid = (w + hi) >> 1;
      if (offsets[mid] <= p) w = mid; else hi = mid;
    }
    int since = 0;                                   // rows of node w in the cells
    int slot = 0;                                    // chunk i's ring slot
    for (int64_t i = 0;; ++i) {
      const int rows = rows_of(i);
      if (rows == 0) break;
      stage(slot == 0 ? kStages - 1 : slot - 1, rows_of(i + kStages - 1));
      cp_async_commit();                             // in flight during this chunk
      const int rows_ahead = rows_of(i + kStages);   // its ids, into registers
      const int64_t ahead = p + (i + kStages) * kChunk;
      int id_ahead[kIds];
#pragma unroll
      for (int q = 0; q < kIds; ++q) {
        const int j = tid + q * kThreads;
        id_ahead[q] = j < rows_ahead ? (int)order[ahead + j] : 0;
      }
      cp_async_wait<kStages - 1>();                  // this chunk has landed
      __syncthreads();

      const uint16_t* bins = reinterpret_cast<const uint16_t*>(
          sbin + slot * kChunk * words);
      const unsigned* packed = sstats + slot * kChunk;
      const uint8_t* odd = sodd + slot * kChunk;
      const int64_t c0 = p + i * kChunk, c1 = c0 + rows;
      for (int64_t pos = c0; pos < c1;) {            // the chunk node by node
        while (offsets[w + 1] <= pos) ++w;
        const int64_t node_end = offsets[w + 1];
        const int64_t seg_end = min64(c1, node_end);
        const int j1 = (int)(seg_end - c0);
        if (k < rpw) {
          for (int j = (int)(pos - c0) + warp * rpw + k; j < j1; j += kWarps * rpw) {
            const int bin = (int)bins[j * 2 * words + odd[j] + fl] - t0;
            // a bin of another tile; out-of-range ids are the caller's bug:
            // never write past the slice
            if ((unsigned)bin < (unsigned)bt) {
              const unsigned st = packed[j];
              int* cell = cells + where.at(fl, bin);
              atomicAdd(cell, low_half(st));
              atomicAdd(cell + plane, high_half(st));
              atomicAdd(cell + 2 * plane, 1);
            }
          }
        }
        since += (int)(seg_end - pos);
        pos = seg_end;
        // the run leaves node w, or one more chunk could pass the window
        if (pos == node_end || pos == p_end || since > window - kChunk) {
          flush(w);
          since = 0;
        }
      }
#pragma unroll
      for (int q = 0; q < kIds; ++q) {               // this slot is spent
        const int j = tid + q * kThreads;
        if (j < rows_ahead) srow[slot * kChunk + j] = id_ahead[q];
      }
      __syncthreads();
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
  }
}

// The histogram launch: uint8 ids over one tile of every bin (tile_bins =
// b), uint16 ids over num_tiles tiles of tile_bins bins, which must start
// on a 4-byte boundary (their rows are staged as the words that cover
// them). The grid is hist_grid's.
cudaError_t launch_quant(const void* binned, const void* stats,
                         const void* order, const void* offsets, void* acc,
                         int f, int b, int width, int f_slice, int num_slices,
                         int window, int bin_bytes, int tile_bins,
                         int num_tiles, int smem, int device, cudaStream_t s) {
  HistGrid g;
  cudaError_t err;
  if (bin_bytes == 1) {
    if (num_tiles != 1 || tile_bins != b) return cudaErrorInvalidValue;
    err = hist_grid(level_hist_quant_kernel, kThreads, smem, 1, num_slices, 1,
                    device, &g);
    if (err != cudaSuccess) return err;
    const int word_bins = f % 4 == 0 && f_slice % 4 == 0 &&
                          (uintptr_t)binned % 4 == 0;
    level_hist_quant_kernel<<<g.ctas, kThreads, smem, s>>>(
        (const uint8_t*)binned, (const unsigned*)stats, (const int64_t*)order,
        (const int64_t*)offsets, (unsigned long long*)acc, f, b, width,
        f_slice, num_slices, word_bins, window);
    return cudaGetLastError();
  }
  if (bin_bytes != 2 || (uintptr_t)binned % 4 != 0 || f_slice < 1 ||
      f_slice > kLanes || tile_bins < 1 || (int64_t)tile_bins * num_tiles < b)
    return cudaErrorInvalidValue;
  err = hist_grid(level_hist_quant_u16_kernel, kThreads, smem, 2, num_slices,
                  num_tiles, device, &g);
  if (err != cudaSuccess) return err;
  level_hist_quant_u16_kernel<<<g.ctas, kThreads, smem, s>>>(
      (const unsigned*)binned, (const unsigned*)stats, (const int64_t*)order,
      (const int64_t*)offsets, (unsigned long long*)acc, f, b, width, f_slice,
      num_slices, window, tile_bins, num_tiles, g.per_tile);
  return cudaGetLastError();
}

// The scales of grad and hess (float32 inverse scales on the device); the
// count channel's is 1.
struct InverseScales {
  const float* g;
  const float* h;
  __device__ double operator()(int c) const {
    return c == 0 ? (double)*g : (c == 1 ? (double)*h : 1.0);
  }
};

}  // namespace

extern "C" {

// Launches the partition (three kernels), the histogram and the dequantization
// on `stream` (a cudaStream_t) of device `device`; `qbits` is 16 (int16
// grad/hess) or 8 (int8); `binned` holds uint8 (bin_bytes 1), uint16 (2, from
// a 4-byte boundary) or int32 (4) ids; `local` int32 (local_bytes 4) or int64
// (8) node ids. Scratch, written here: `stats` n packed uint32; `counts`
// (width + 1) * (ns + nb) int32 for ns = ceil(n / 512) warp segments and nb =
// ceil(ns / 8) CTAs; `offsets` width + 1 int64; `order` n int64; `wide`, for
// int32 ids only (else null), hist_cuda.i32_scratch_bytes(n, f, 4) bytes from
// a 16-byte boundary (I32Scratch: the items' counter, the node-ordered packed
// words, the (f, n) int32 columns, their tile keys). `acc` holds the width * f * b * 3 int64
// sums, in the layout of `out`: the histogram adds into them, so they are zero
// on entry for one histogram, or a running sum that each call adds a chunk of
// rows into (integer adds commute, so the sums of the chunks are the one
// pass's). `out` is the (width, f, b, 3) float32 histogram, dequantized from
// `acc`; a null `out` skips the dequantization (the scales are then not read:
// mmls_level_hist_quant_dequantize runs it once the chunks are in). On int32
// ids the sums stay in shared memory: with `out` the histogram writes it
// directly and `acc` is not read (it may be null), with `out` null it adds
// its nonzero sums into `acc`. The bins go in num_tiles tiles of tile_bins
// (uint8 ids: one tile, tile_bins = b); `smem` a histogram CTA's dynamic
// shared memory (hist_cuda.quant_smem_bytes / quant_u16_smem_bytes /
// i32_smem_bytes); `window` the rows of one node a CTA's int32 cells take
// between flushes (hist_cuda.quant_window). width must not pass 12287 (the
// partition's per-warp key counters), n must be below 2^31. Returns the first
// CUDA error: 0 on success.
int mmls_level_hist_quant(const void* binned, const void* grad,
                          const void* hess, const void* live,
                          const void* local, int local_bytes, void* stats,
                          void* counts, void* offsets, void* order,
                          void* wide, void* acc, void* out,
                          const void* gscale_inv, const void* hscale_inv,
                          int qbits, long long n, int f, int b, int width,
                          int f_slice, int num_slices, int bin_bytes,
                          int tile_bins, int num_tiles, int smem, int window,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool i32 = bin_bytes == 4;
  if (width > kMaxWidth || window < kChunk ||
      (bin_bytes != 1 && bin_bytes != 2 && !i32) ||
      i32 != (wide != nullptr) ||
      (i32 && (smem != i32_smem(tile_bins) ||
               !i32_tiles_ok(b, tile_bins, num_tiles))) ||
      (out == nullptr && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* wcounts = (int*)counts;
  int* btot = wcounts + plan_wcounts(n, width);
  if (qbits == 16)
    err = plan_quant<int16_t>(local, local_bytes, live, grad, hess,
                              (unsigned*)stats, wcounts, btot,
                              (int64_t*)offsets, (int64_t*)order, n, width, s);
  else if (qbits == 8)
    err = plan_quant<int8_t>(local, local_bytes, live, grad, hess,
                             (unsigned*)stats, wcounts, btot,
                             (int64_t*)offsets, (int64_t*)order, n, width, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  const InverseScales scales{(const float*)gscale_inv,
                             (const float*)hscale_inv};
  if (i32) {
    const I32Scratch<unsigned> w(wide, n, f);
    err = gather_i32(binned, (const unsigned*)stats, (const int64_t*)order,
                     (const int64_t*)offsets, w, n, f, width, tile_bins, s);
    if (err != cudaSuccess) return (int)err;
    const QuantTerms terms{w.nstats};
    return (int)(out == nullptr
        ? launch_i32(w, terms, MergeOut{(long long*)acc},
                     (const int64_t*)offsets, n, f, b, width, tile_bins,
                     num_tiles, device, s)
        : launch_i32(w, terms, DequantOut<InverseScales>{(float*)out, scales},
                     (const int64_t*)offsets, n, f, b, width, tile_bins,
                     num_tiles, device, s));
  }
  err = launch_quant(binned, stats, order, offsets, acc, f, b, width,
                     f_slice, num_slices, window, bin_bytes, tile_bins,
                     num_tiles, smem, device, s);
  if (err != cudaSuccess || out == nullptr) return (int)err;
  return (int)dequantize((const long long*)acc, (float*)out, scales,
                         (int64_t)width * f * b * 3, s);
}

// The dequantization of mmls_level_hist_quant alone, on `stream` of
// `device`: out[i] = float(double(acc[i]) * scale(i % 3)) over the `count`
// cells of a (width, f, b, 3) int64 `acc` (count = width * f * b * 3),
// scale 0 and 1 the float32 inverse scales on the device, 2 the count's 1.
// Returns the first CUDA error: 0 on success.
int mmls_level_hist_quant_dequantize(const void* acc, void* out,
                                     const void* gscale_inv,
                                     const void* hscale_inv, long long count,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (count < 0 || count % 3 != 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  return (int)dequantize(
      (const long long*)acc, (float*)out,
      InverseScales{(const float*)gscale_inv, (const float*)hscale_inv},
      (int64_t)count, (cudaStream_t)stream);
}

// The histogram launch's grid on `device` at these arguments of
// mmls_level_hist_quant: out[0..3] = SMs, CTAs per SM, CTAs launched, CTAs
// per tile of bins (hist_cuda.launch_geometry). Returns the first CUDA
// error.
int mmls_level_hist_quant_grid(int bin_bytes, int smem, int num_slices,
                               int num_tiles, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HistGrid g;
  err = bin_bytes == 1
      ? hist_grid(level_hist_quant_kernel, kThreads, smem, 1, num_slices,
                  num_tiles, device, &g)
      : bin_bytes == 4
      ? hist_grid(hist_i32_kernel<QuantTerms, DequantOut<InverseScales>>,
                  kI32Threads, smem, 4, num_slices, num_tiles, device, &g)
      : hist_grid(level_hist_quant_u16_kernel, kThreads, smem, 2, num_slices,
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

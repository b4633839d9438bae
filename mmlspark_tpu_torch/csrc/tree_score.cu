// Tree-ensemble scoring for Hopper (sm_90a): every tree of a boosted
// ensemble over a batch of rows, in one launch.
//
// Replaces the JAX package's scorers, mmlspark_tpu/models/gbdt/booster.py
// predict_binned_fn (:222, bin ids) and predict_fn (:263, raw float32
// features): a jax.jit of a lax.scan over the trees, one XLA program per
// shape, not a Pallas kernel. It computes what they return. Each tree is a
// full binary layout of `nodes` slots (node i's children 2i+1 / 2i+2,
// split_feature < 0 at a leaf); a row walks it from the root for at most
// `depth` steps, left where
//   - bin ids (uint8, uint16, int32): bin <= threshold_bin;
//   - raw float32 features: isnan(x) || x <= float32(threshold_value);
// and stops at the first leaf, the leaf the scan's "node stays" rule keeps.
// Tree t adds leaf * weight to class t % K of the row, in tree order, from
// float32(init_score), each add rounded once:
//   acc = float(double(acc) + double(leaf) * double(weight))
// The product of two float32 values is exact in float64, so the one
// rounding is the fused multiply-add XLA makes of the scan's
// acc + leaf * weight (ROADMAP C9; booster._add_tree). The intrinsics
// (__dmul_rn, __dadd_rn, __double2float_rn) fix that sequence whatever
// --fmad says. Routing is integer (or exact float) work and the fold a fixed
// sequence of float64 operations, so the kernel returns the plain version's
// bits (score_cuda.tree_score_reference). A bfloat16 leaf table
// (autocast "bf16") is promoted to float32 first, as the plain version does.
//
// Design. A CTA takes a tile of kRows = 32 rows, a lane per row, and its
// kTreeLanes = 8 warps stride over the trees: warp w walks trees w, w + 8,
// ... for its 32 rows, so the lanes of a warp read one tree's table (the
// root's entry is one broadcast) and the bytes of 32 neighbouring rows. Each
// (row, tree) contribution goes to shared memory, kTreeTile = 64 trees at a
// time (16 KB of float64). After a barrier one thread per (row, class)
// folds the tile in tree order into the row's float32 output, which it
// keeps in device memory between tiles (it is the only thread that touches
// it). The tables (int32 split features, int32 or float32 thresholds,
// float32 or bfloat16 leaves, float32 tree weights) are copied to the card
// once per scorer; the served model's are about 150 KB and stay in L2.
//
// What bounds it. The function must read the (N, F) input once, the tables
// once and write the (N, K) float32 output: at N = 2M, F = 28 uint8 bin ids
// about 64 MB, some 19 us at 3.35 TB/s; its operations (depth compares and a
// multiply-add per row and tree) are far below the card's rates. The walk
// is not: each of its `depth` steps is a chain of dependent loads (the split
// feature, then the row's value, beside the threshold), so at serving sizes
// (a few rows, a hundred trees) a chain of depth dependent L2 loads per tree
// sets the floor, and at 2M rows the load instructions of all the walks do.
// A simple kernel that is right comes first; making it fast is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;       // rows of a CTA: a lane per row
constexpr int kTreeLanes = 8;   // warps of a CTA, each on one tree at a time
constexpr int kThreads = kRows * kTreeLanes;
constexpr int kTreeTile = 64;   // trees folded per barrier

// Left-routing rule and threshold type per input type.
template <typename In>
struct Route {  // bin ids: uint8, uint16, int32
  using Thr = int32_t;
  static __device__ __forceinline__ bool left(In v, int32_t t) {
    return static_cast<int32_t>(v) <= t;
  }
};

template <>
struct Route<float> {  // raw features: NaN goes left
  using Thr = float;
  static __device__ __forceinline__ bool left(float v, float t) {
    return isnan(v) || v <= t;
  }
};

__device__ __forceinline__ float leaf_f32(float v) { return v; }
__device__ __forceinline__ float leaf_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename In, typename Leaf>
__global__ void __launch_bounds__(kThreads)
    tree_score_kernel(const In* __restrict__ x,
                      const int32_t* __restrict__ split_feature,
                      const typename Route<In>::Thr* __restrict__ threshold,
                      const Leaf* __restrict__ leaf,
                      const float* __restrict__ tree_weight,
                      float* __restrict__ out, float init_score, int64_t n,
                      int f, int trees, int nodes, int depth, int k) {
  __shared__ double contrib[kTreeTile][kRows];
  const int lane = threadIdx.x % kRows;
  const int tree_lane = threadIdx.x / kRows;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const bool live = row0 + lane < n;
  const In* xr = x + (live ? row0 + lane : 0) * static_cast<int64_t>(f);

  // with no trees, one pass writes init_score
  for (int t0 = 0; t0 == 0 || t0 < trees; t0 += kTreeTile) {
    const int tile = max(0, min(kTreeTile, trees - t0));
    if (live) {
      for (int tt = tree_lane; tt < tile; tt += kTreeLanes) {
        const int64_t base = static_cast<int64_t>(t0 + tt) * nodes;
        const int32_t* sf = split_feature + base;
        const typename Route<In>::Thr* thr = threshold + base;
        int node = 0;
        for (int d = 0; d < depth; ++d) {
          const int feat = sf[node];
          if (feat < 0) break;
          node = Route<In>::left(xr[feat], thr[node]) ? 2 * node + 1
                                                      : 2 * node + 2;
        }
        contrib[tt][lane] =
            __dmul_rn(static_cast<double>(leaf_f32(leaf[base + node])),
                      static_cast<double>(tree_weight[t0 + tt]));
      }
    }
    __syncthreads();
    // one thread per (row, class): the tile's trees of that class, in order
    for (int p = threadIdx.x; p < kRows * k; p += kThreads) {
      const int r = p % kRows;
      const int c = p / kRows;
      if (row0 + r >= n) continue;
      float* o = out + (row0 + r) * k + c;
      float acc = t0 == 0 ? init_score : *o;
      for (int t = t0 + (c - t0 % k + k) % k; t < t0 + tile; t += k)
        acc = __double2float_rn(
            __dadd_rn(static_cast<double>(acc), contrib[t - t0][r]));
      *o = acc;
    }
    __syncthreads();
  }
}

template <typename In, typename Leaf>
cudaError_t launch(const void* x, const void* sf, const void* thr,
                   const void* nv, const void* tw, void* out, float init,
                   int64_t n, int f, int trees, int nodes, int depth, int k,
                   cudaStream_t s) {
  const int64_t blocks = (n + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  tree_score_kernel<In, Leaf><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
      static_cast<const In*>(x), static_cast<const int32_t*>(sf),
      static_cast<const typename Route<In>::Thr*>(thr),
      static_cast<const Leaf*>(nv), static_cast<const float*>(tw),
      static_cast<float*>(out), init, n, f, trees, nodes, depth, k);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_leaf(int leaf_code, const void* x, const void* sf,
                        const void* thr, const void* nv, const void* tw,
                        void* out, float init, int64_t n, int f, int trees,
                        int nodes, int depth, int k, cudaStream_t s) {
  if (leaf_code == 0)
    return launch<In, float>(x, sf, thr, nv, tw, out, init, n, f, trees,
                             nodes, depth, k, s);
  if (leaf_code == 1)
    return launch<In, __nv_bfloat16>(x, sf, thr, nv, tw, out, init, n, f,
                                     trees, nodes, depth, k, s);
  return cudaErrorInvalidValue;
}

cudaError_t launch_x(int x_code, int leaf_code, const void* x, const void* sf,
                     const void* thr, const void* nv, const void* tw,
                     void* out, float init, int64_t n, int f, int trees,
                     int nodes, int depth, int k, cudaStream_t s) {
  switch (x_code) {
    case 1:
      return launch_leaf<uint8_t>(leaf_code, x, sf, thr, nv, tw, out, init, n,
                                  f, trees, nodes, depth, k, s);
    case 2:
      return launch_leaf<uint16_t>(leaf_code, x, sf, thr, nv, tw, out, init,
                                   n, f, trees, nodes, depth, k, s);
    case 4:
      return launch_leaf<int32_t>(leaf_code, x, sf, thr, nv, tw, out, init, n,
                                  f, trees, nodes, depth, k, s);
    case 5:
      return launch_leaf<float>(leaf_code, x, sf, thr, nv, tw, out, init, n,
                                f, trees, nodes, depth, k, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Scores the row-major (n, f) `x` through `trees` trees of `nodes` slots on
// `stream` (a cudaStream_t) of device `device`, into the row-major (n, k)
// float32 `out`. x_code: 1 uint8, 2 uint16, 4 int32 bin ids against int32
// `thr`; 5 raw float32 features against float32 `thr`. leaf_code: 0 float32,
// 1 bfloat16 leaf values `nv`. `sf` holds int32 split features (< f, or < 0
// at a leaf), `tw` the float32 tree weights; nodes >= 2^(depth+1) - 1.
// Returns the first CUDA error: 0 on success.
int mmls_tree_score(const void* x, int x_code, const void* sf, const void* thr,
                    const void* nv, int leaf_code, const void* tw, void* out,
                    float init_score, long long n, int f, int trees, int nodes,
                    int depth, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_x(x_code, leaf_code, x, sf, thr, nv, tw, out, init_score,
                       n, f, trees, nodes, depth, k, (cudaStream_t)stream);
}

// One served batch in one call: copies the (n, f) rows from the pinned
// `host_x` to `x` on the card, scores them as mmls_tree_score does into
// `out`, copies the (n, k) scores to the pinned `host_out`, and waits for
// the stream. Returns the first CUDA error: 0 on success.
int mmls_tree_score_staged(const void* host_x, void* x, int x_code,
                           long long x_bytes, const void* sf, const void* thr,
                           const void* nv, int leaf_code, const void* tw,
                           void* out, void* host_out, float init_score,
                           long long n, int f, int trees, int nodes,
                           int depth, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemcpyAsync(x, host_x, x_bytes, cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_x(x_code, leaf_code, x, sf, thr, nv, tw, out, init_score, n, f,
                 trees, nodes, depth, k, s);
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

// Fused softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel mmlspark_tpu/parallel/flash.py:_flash_kernel
// (driven by _flash_call through flash_attention). It computes what that
// kernel returns: out = softmax(q k^T / sqrt(d), masked) v for q of shape
// (b, n, h, d) and k, v of shape (b, nk, h, d), with the online-softmax
// recurrence in float32 over KV tiles, so the (n, nk) scores never exist
// in device memory. Inputs are float32 or bfloat16 (all three the same
// type); the output has q's type and is rounded once, to nearest even.
//
// Numbers kept from the TPU kernel: q is scaled by 1/sqrt(d) in float32
// before the product; masked scores are -1e30, not -inf; the result is
// acc / max(l, 1e-30). Causal masking is top-left aligned: query i sees
// key j when i >= j, both counted from 0 even when nk != n.
//
// Why not a block-by-block copy of the TPU design. The Pallas kernel runs
// one program per (batch*head, q block) with the whole per-head K/V stream
// resident in VMEM, and its products go to the MXU. Here a CTA has at most
// 227 KB of shared memory, so K/V are streamed through it in tiles, and
// this first version computes on the CUDA cores in full float32, as the TPU
// kernel does (no TF32 tensor cores; wgmma and TMA are later work).
//
// Design. One CTA of 8 warps per (batch*head, 64-row q tile); the layout
// (b, n, h, d) is read in place through strides (the TPU wrapper's
// transposes to (b*h, n, d) would cost two extra passes over device
// memory). The q tile, scaled, and each 64-key K and V tile are staged in
// shared memory as float32 rows padded to D + 4 floats, D being d rounded
// up to a bucket of 32, 64 or 128 (the zero padding adds exact zeros to
// every product). Each warp owns 8 q rows. For the scores, lane l holds
// keys l and l + 32 of the tile: a float4 read of a K row per lane (the
// padded stride keeps those reads free of bank conflicts) against float4
// broadcasts of the 8 q rows. Row max and row sum are warp shuffles. The
// probabilities go through a per-warp slice of shared memory so that, for
// P.V, each lane owns D/32 output columns of all 8 rows: accumulators stay
// in registers for the whole KV loop. No atomics, and a fixed order of
// every sum, so two launches on the same inputs give the same bits.
//
// Skipping tiles above the diagonal is exact. For a row that sees no key
// of a tile, the TPU recurrence gets scores of -1e30, p = exp(-1e30 - m) =
// 0 and corr = exp(m - m) = 1 (m is finite after tile 0, which always
// holds key 0), so acc, m and l are unchanged bit for bit. So a CTA stops
// at the last tile its rows can see, and a warp skips a tile that lies
// wholly above its rows.
//
// What bounds it. The function reads q, k and v once and writes the
// output once: at b=4, n=2048, h=8, d=64 in float32 that is 67 MB, 20 us
// at the H100 SXM's 3.35 TB/s. It does 4*d operations per unmasked
// (query, key) pair: 34.4 GFLOP non-causal, 17.2 GFLOP causal, 0.51 ms and
// 0.26 ms at the 67 TFLOP/s float32 rate outside the tensor cores. So the
// bound is operations. Per 4 columns of the score loop a warp issues 10
// shared loads for 64 FMAs, and per 4 keys of the P.V loop 12 loads for
// 4*8*D/32 FMAs; shared-memory bandwidth, the accurate expf and the
// shuffles are the overheads over the bound, and the K/V tiles are loaded
// without overlap with compute (other CTAs on the SM hide the latency).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;                   // q rows per warp
constexpr int kBlockQ = kWarps * kRows;    // q rows per CTA
constexpr int kBlockK = 64;                // keys per KV tile: two per lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;          // the TPU kernel's mask value

struct Strides {                           // in elements; d has stride 1
  long long b, n, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);               // round to nearest even
}

// CPL consecutive floats of shared memory as one vector load
template <int CPL>
__device__ __forceinline__ void load_cols(const float* p, float* o) {
  if constexpr (CPL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (CPL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = p[0];
  }
}

__device__ __forceinline__ float comp(const float4& t, int i) {
  return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <int D>
constexpr int smem_floats() {
  return (kBlockQ + 2 * kBlockK) * (D + 4) + kWarps * kRows * kBlockK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int h, int n,
                  int nk, int d, Strides sq, Strides sk, Strides sv,
                  Strides so, float scale, int causal) {
  constexpr int S = D + 4;       // padded row: float4-aligned, conflict-free
  constexpr int CPL = D / 32;    // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBlockQ][S]
  float* ks = qs + kBlockQ * S;                  // [kBlockK][S]
  float* vs = ks + kBlockK * S;                  // [kBlockK][S]
  float* ps = vs + kBlockK * S;                  // [kWarps][kRows][kBlockK]

  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  // the last q tiles see the most keys under a causal mask: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + bi * sq.b + hi * sq.h;
  const T* kb = k + bi * sk.b + hi * sk.h;
  const T* vb = v + bi * sv.b + hi * sv.h;
  T* ob = out + bi * so.b + hi * so.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qp = q0 + r;
    qs[r * S + c] = (qp < n && c < d)
        ? to_f32(qb[(long long)qp * sq.n + c]) * scale : 0.f;
  }

  const int r0 = warp * kRows;                 // the warp's rows in the tile
  const int warp_last = q0 + r0 + kRows - 1;   // its last query position
  float acc[kRows][CPL], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[r][cc] = 0.f;
  }

  int tiles = (nk + kBlockK - 1) / kBlockK;
  if (causal) tiles = min(tiles, (q0 + kBlockQ - 1) / kBlockK + 1);
  float* pw = ps + warp * kRows * kBlockK;

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // the last tile's readers are done (and qs is written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D, kp = k0 + j;
      const bool in = kp < nk && c < d;   // zeros past nk: p = 0 never meets NaN
      ks[j * S + c] = in ? to_f32(kb[(long long)kp * sk.n + c]) : 0.f;
      vs[j * S + c] = in ? to_f32(vb[(long long)kp * sv.n + c]) : 0.f;
    }
    __syncthreads();
    if (causal && k0 > warp_last) continue;    // exact: see the note above

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ks + lane * S + c);
      const float4 kc =
          *reinterpret_cast<const float4*>(ks + (lane + 32) * S + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * S + c);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kc, s[r][1]);
      }
    }

    float corr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + lane + 32 * jj;
        if (kp >= nk || (causal && qp < kp)) s[r][jj] = kNegInf;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float new_m = fmaxf(m[r], mx);
      const float p0 = expf(s[r][0] - new_m);
      const float p1 = expf(s[r][1] - new_m);
      corr[r] = expf(m[r] - new_m);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr[r] + sum;
      m[r] = new_m;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) acc[r][cc] *= corr[r];
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPL];
        load_cols<CPL>(vs + (j + jj) * S + lane * CPL, vv);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = comp(pr[r], jj);
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
            acc[r][cc] = fmaf(p, vv[cc], acc[r][cc]);
        }
      }
    }
    __syncwarp();      // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= n) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int c = lane * CPL + cc;
      if (c < d) store(ob + (long long)qp * so.n + c, acc[r][cc] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int n, int nk, int d, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((n + kBlockQ - 1) / kBlockQ));
  flash_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, n, nk, d, sq, sk,
      sv, so, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int h, int n, int nk, int d, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so, scale,
                         causal, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so, scale,
                         causal, stream);
  return launch<T, 128>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so, scale,
                        causal, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// dtype 0: float32, 1: bfloat16 (q, k, v and out alike). Strides are in
// elements, for the b, n and h axes; d must be contiguous and 1 <= d <= 128.
// b * h (the grid's x axis, an int in the kernel) must stay below 2^31; a
// grid y of more than 65535 q tiles fails the launch itself.
// Returns cudaGetLastError() after the launch: 0 on success.
int mmls_flash_attn(const void* q, const void* k, const void* v, void* out,
                    int dtype, int b, int h, int n, int nk, int d,
                    long long q_sb, long long q_sn, long long q_sh,
                    long long k_sb, long long k_sn, long long k_sh,
                    long long v_sb, long long v_sn, long long v_sh,
                    long long o_sb, long long o_sn, long long o_sh,
                    float scale, int causal, int device, void* stream) {
  if (d < 1 || d > 128 || (dtype != 0 && dtype != 1) ||
      (long long)b * h >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                           scale, causal, s);
  return launch_d<__nv_bfloat16>(q, k, v, out, b, h, n, nk, d, sq, sk, sv,
                                 so, scale, causal, s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

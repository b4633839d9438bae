// Fused softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel mmlspark_tpu/parallel/flash.py:_flash_kernel
// (driven by _flash_call through flash_attention). It computes what that
// kernel returns: out = softmax(q k^T / sqrt(d), masked) v for q of shape
// (b, n, h, d) and k, v of shape (b, nk, h, d), with the online-softmax
// recurrence in float32 over KV tiles, so the (n, nk) scores never exist
// in device memory. Inputs and output are float32.
//
// Numbers kept from the TPU kernel: q is scaled by 1/sqrt(d) in float32
// before the product; masked scores are -1e30, not -inf; the result is
// acc / max(l, 1e-30). Causal masking is top-left aligned: query i sees
// key j when i >= j, both counted from 0 even when nk != n.
//
// Why not a block-by-block copy of the TPU design. The Pallas kernel runs
// one program per (batch*head, q block) with the whole per-head K/V stream
// resident in VMEM, and its products go to the MXU. Here a CTA has at most
// 227 KB of shared memory, so K/V are streamed through it in tiles, and the
// kernel computes on the CUDA cores in full float32, as the TPU kernel does
// (no TF32 tensor cores: SDPA's float32 yardstick errs by about 2e-6, and
// the gate below is the plain version's at rtol 2e-4 / atol 2e-5). bfloat16
// calls run csrc/flash_attn_sm90.cu; this kernel takes float32 only.
//
// Design. One CTA of 8 warps per (batch*head, 128-row q tile), the last q
// tiles (which see the most keys under a causal mask) launched first; the
// layout (b, n, h, d) is read in place through strides. D is d rounded up
// to a bucket of 32, 64, 96 or 128; columns past d are zero in shared
// memory, and add exact zeros to every product.
//   - The q tile, scaled in float32, is staged once, rows padded to D + 4
//     floats. K tiles of 64 keys (rows padded alike) arrive by cp.async
//     into a two-stage ring, tile t+1 in flight while tile t is used; the
//     V tile arrives by cp.async while the scores and the softmax of its
//     tile run. Rows past nk are zero-filled by the copy. 16-byte copies
//     where d, the strides and the bases allow, 4-byte copies otherwise.
//   - Register micro-tiles: thread (ty, tx), ty < 32, tx < 8, owns q rows
//     ty + 32i (i < 4) and keys tx + 8j (j < 8) of S, and the same rows'
//     output columns 4tx + 32g + e (e < 4, g < D/32). Per 4 columns of the
//     score loop a thread loads 4 q and 8 K float4s for 128 FMAs (the old
//     8-row warp tiles: 10 loads per 64); a warp's 4 q rows and 8 keys are
//     consecutive padded rows, so each float4 load is one conflict-free
//     wavefront. P goes through shared memory (the thread that owns a
//     score does not own the output columns it feeds): per 4 keys of P.V a
//     thread loads 4 P and 4*D/32 V float4s for 16*D/8 FMAs; each row of P
//     is written and read by one warp only.
//   - The causal mask is applied on the tiles that cross the diagonal (or
//     hold keys past nk) only.
// No atomics, and a fixed order of every sum, so two launches on the same
// inputs give the same bits. The order is also that of this kernel's first
// design (64-row q tiles, 8 rows per warp, a lane per 2 keys): each score is
// one FMA chain over the columns in order, P.V adds the keys in order, and
// a row's sum of p adds its keys in the same tree as that design's warp
// shuffles; so the two give the same bits (tools/torch_flash_ab.py shows it).
// Measured on the card and not kept: 4 warps per CTA (two CTAs per SM), a
// second V stage (two barriers per tile instead of three), __expf (no
// faster, and other bits).
//
// Skipping tiles above the diagonal is exact. For a row that sees no key
// of a tile, the TPU recurrence gets scores of -1e30, p = exp(-1e30 - m) =
// 0 and corr = exp(m - m) = 1 (m is finite after tile 0, which always
// holds key 0), so acc, m and l are unchanged bit for bit. So a CTA stops
// at the last tile its rows can see.
//
// What bounds it. The function reads q, k and v once and writes the
// output once: at b=4, n=2048, h=8, d=64 in float32 that is 67 MB, 20 us
// at the H100 SXM's 3.35 TB/s. It does 4*d operations per unmasked
// (query, key) pair: 34.4 GFLOP non-causal, 17.2 GFLOP causal, 0.51 ms and
// 0.26 ms at the 67 TFLOP/s float32 rate outside the tensor cores. So the
// bound is operations. Over it: the shared loads beside the FMAs (above),
// the accurate expf (one per pair), the row reductions, the three CTA
// barriers per tile, and, causal, the masked half of each diagonal tile.
// The register tiles take 252 registers at D = 128, so a CTA of 8 warps is
// all an SM holds: latency is hidden by the 32 independent FMA chains of a
// thread, not by other warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTy = kThreads / 8;          // thread (ty, tx), tx < 8
constexpr int kRowsPT = 4;                 // q rows per thread: ty + kTy*i
constexpr int kKeysPT = 8;                 // keys per thread: tx + 8j
constexpr int kBlockQ = kTy * kRowsPT;     // q rows per CTA
constexpr int kBlockK = 64;                // keys per K/V tile
constexpr float kNegInf = -1e30f;          // the TPU kernel's mask value

struct Strides {                           // in elements; d has stride 1
  long long b, n, h;
};

template <int D>
struct Layout {
  static constexpr int SQ = D + 4;         // q and K rows: float4-aligned, conflict-free
  static constexpr int SV = D;             // V rows
  static constexpr int SP = kBlockK + 4;   // P rows
  static constexpr int Q = 0;
  static constexpr int K = Q + kBlockQ * SQ;           // two stages
  static constexpr int V = K + 2 * kBlockK * SQ;
  static constexpr int P = V + kBlockK * SV;
  static constexpr int floats = P + kBlockQ * SP;
  // unrolling of the score and P.V loops, as measured on the card: whole
  // at D = 64, 4 at D = 32 and 96 (whole costs time at D = 32), 2 at
  // D = 128 (deeper costs registers and time)
  static constexpr int Unroll = D == 64 ? 16 : D == 128 ? 2 : 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of one tile of 64 key rows (k0..k0+63) into `dst`
// (rows of `stride` floats): columns below d only, rows past nk zero-filled.
template <int D, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, long long sn,
                                          int k0, int nk, int d) {
  if constexpr (kVec) {                    // d % 4 == 0, 16-byte aligned rows
    constexpr int C4 = D / 4;
    for (int i = threadIdx.x; i < kBlockK * C4; i += kThreads) {
      const int j = i / C4, c = (i % C4) * 4;
      if (c >= d) continue;
      const bool in = k0 + j < nk;
      cp_async16(dst + j * stride + c, in ? src + (k0 + j) * sn + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int j = i / D, c = i % D;
      if (c >= d) continue;
      const bool in = k0 + j < nk;
      cp_async4(dst + j * stride + c, in ? src + (k0 + j) * sn + c : src,
                in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ float comp(const float4& t, int i) {
  return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
}

template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int h, int n, int nk, int d, Strides sq, Strides sk,
                  Strides sv, Strides so, float scale, int causal) {
  using L = Layout<D>;
  constexpr int G = D / 32;                // float4 groups of output columns
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* qs = sm + L::Q;
  float* ks = sm + L::K;
  float* vs = sm + L::V;
  float* ps = sm + L::P;

  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = (tid >> 5) * 4 + (lane >> 3), tx = lane & 7;
  const float* qb = q + bi * sq.b + hi * sq.h;
  const float* kb = k + bi * sk.b + hi * sk.h;
  const float* vb = v + bi * sv.b + hi * sv.h;
  float* ob = out + bi * so.b + hi * so.h;

  int tiles = (nk + kBlockK - 1) / kBlockK;
  if (causal) tiles = min(tiles, (q0 + kBlockQ - 1) / kBlockK + 1);
  if (tiles > 0) {
    load_tile<D, kVec>(ks, L::SQ, kb, sk.n, 0, nk, d);
    cp_async_commit();
    load_tile<D, kVec>(vs, L::SV, vb, sv.n, 0, nk, d);
    cp_async_commit();
  }
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, qp = q0 + r;
    qs[r * L::SQ + c] = (qp < n && c < d)
        ? qb[(long long)qp * sq.n + c] * scale : 0.f;
  }
  for (int i = tid; i < kBlockK * (D - d); i += kThreads) {
    const int j = i / (D - d), c = d + i % (D - d);   // columns no copy writes
    ks[j * L::SQ + c] = 0.f;
    ks[(kBlockK + j) * L::SQ + c] = 0.f;
    vs[j * L::SV + c] = 0.f;
  }

  float acc[kRowsPT][G][4], m[kRowsPT], l[kRowsPT];
#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBlockK;
    if (t + 1 < tiles)
      load_tile<D, kVec>(ks + ((t + 1) & 1) * kBlockK * L::SQ, L::SQ, kb,
                         sk.n, k0 + kBlockK, nk, d);
    cp_async_commit();
    cp_async_wait<2>();                    // K(t) has landed
    __syncthreads();

    // S = (q * scale) K^T: one FMA chain per score, columns in order
    const float* kt = ks + (t & 1) * kBlockK * L::SQ;
    float s[kRowsPT][kKeysPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPT; ++j) s[i][j] = 0.f;
#pragma unroll (L::Unroll)
    for (int c = 0; c < D; c += 4) {
      float4 qa[kRowsPT], kv[kKeysPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + kTy * i) * L::SQ + c);
#pragma unroll
      for (int j = 0; j < kKeysPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 8 * j) * L::SQ + c);
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPT; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kv[j].x, a);
          a = fmaf(qa[i].y, kv[j].y, a);
          a = fmaf(qa[i].z, kv[j].z, a);
          s[i][j] = fmaf(qa[i].w, kv[j].w, a);
        }
    }

    if ((causal && k0 + kBlockK - 1 > q0) || k0 + kBlockK > nk) {
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPT; ++j) {
          const int kp = k0 + tx + 8 * j;
          if (kp >= nk || (causal && q0 + ty + kTy * i < kp))
            s[i][j] = kNegInf;
        }
    }

    // online softmax: a row's 64 keys lie with the 8 lanes of one tx group
    float corr[kRowsPT];
#pragma unroll
    for (int i = 0; i < kRowsPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kKeysPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float new_m = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - new_m);
#pragma unroll
      for (int j = 0; j < kKeysPT; ++j) s[i][j] = expf(s[i][j] - new_m);
      // keys tx + 8j summed as ((j0+j4) + (j2+j6)) + ((j1+j5) + (j3+j7)),
      // then across tx: the tree of the first version's shuffles
      float sum = ((s[i][0] + s[i][4]) + (s[i][2] + s[i][6])) +
                  ((s[i][1] + s[i][5]) + (s[i][3] + s[i][7]));
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = new_m;
      float* prow = ps + (ty + kTy * i) * L::SP + tx;
#pragma unroll
      for (int j = 0; j < kKeysPT; ++j) prow[8 * j] = s[i][j];
    }
    cp_async_wait<1>();                    // V(t) has landed
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPT; ++i)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr[i];
#pragma unroll (L::Unroll)
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pr[kRowsPT];
#pragma unroll
      for (int i = 0; i < kRowsPT; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (ty + kTy * i) * L::SP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          vv[g] = *reinterpret_cast<const float4*>(vs + (j + jj) * L::SV +
                                                   tx * 4 + 32 * g);
#pragma unroll
        for (int i = 0; i < kRowsPT; ++i) {
          const float p = comp(pr[i], jj);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[i][g][0] = fmaf(p, vv[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv[g].w, acc[i][g][3]);
          }
        }
      }
    }
    __syncthreads();                       // V and this tile's K are free
    if (t + 1 < tiles)
      load_tile<D, kVec>(vs, L::SV, vb, sv.n, k0 + kBlockK, nk, d);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRowsPT; ++i) {
    const int qp = q0 + ty + kTy * i;
    if (qp >= n) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tx * 4 + 32 * g + e;
        if (c < d) ob[(long long)qp * so.n + c] = acc[i][g][e] / den;
      }
  }
}

template <int D, bool kVec>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int n, int nk, int d, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, int causal, cudaStream_t stream) {
  const int smem = Layout<D>::floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<D, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((n + kBlockQ - 1) / kBlockQ));
  flash_attn_kernel<D, kVec><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, h, n,
      nk, d, sq, sk, sv, so, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_vec(bool vec, const void* q, const void* k, const void* v,
               void* out, int b, int h, int n, int nk, int d, Strides sq,
               Strides sk, Strides sv, Strides so, float scale, int causal,
               cudaStream_t stream) {
  if (vec)
    return launch<D, true>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                           scale, causal, stream);
  return launch<D, false>(q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                          scale, causal, stream);
}

// 16-byte copies need every K and V row 16-byte aligned: d and the b, n, h
// strides multiples of 4 floats and the bases 16-byte aligned
bool rows_aligned(const void* k, const void* v, int d, Strides sk,
                  Strides sv) {
  return d % 4 == 0 && (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0 &&
         sk.b % 4 == 0 && sk.n % 4 == 0 && sk.h % 4 == 0 && sv.b % 4 == 0 &&
         sv.n % 4 == 0 && sv.h % 4 == 0;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// dtype must be 0 (float32: q, k, v and out alike; bfloat16 runs
// flash_attn_sm90.cu). Strides are in elements, for the b, n and h axes; d
// must be contiguous and 1 <= d <= 128. b * h (the grid's x axis, an int in
// the kernel) must stay below 2^31; a grid y of more than 65535 q tiles
// fails the launch itself. Returns cudaGetLastError() after the launch: 0
// on success.
int mmls_flash_attn(const void* q, const void* k, const void* v, void* out,
                    int dtype, int b, int h, int n, int nk, int d,
                    long long q_sb, long long q_sn, long long q_sh,
                    long long k_sb, long long k_sn, long long k_sh,
                    long long v_sb, long long v_sn, long long v_sh,
                    long long o_sb, long long o_sn, long long o_sh,
                    float scale, int causal, int device, void* stream) {
  if (d < 1 || d > 128 || dtype != 0 || (long long)b * h >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{q_sb, q_sn, q_sh}, sk{k_sb, k_sn, k_sh},
      sv{v_sb, v_sn, v_sh}, so{o_sb, o_sn, o_sh};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = rows_aligned(k, v, d, sk, sv);
  if (d <= 32)
    return launch_vec<32>(vec, q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                          scale, causal, s);
  if (d <= 64)
    return launch_vec<64>(vec, q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                          scale, causal, s);
  if (d <= 96)
    return launch_vec<96>(vec, q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                          scale, causal, s);
  return launch_vec<128>(vec, q, k, v, out, b, h, n, nk, d, sq, sk, sv, so,
                         scale, causal, s);
}

const char* mmls_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

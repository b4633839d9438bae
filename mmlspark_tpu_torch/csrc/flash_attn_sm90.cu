// Flash attention for Hopper (sm_90a) on bfloat16 inputs: wgmma on the
// tensor cores, TMA into an mbarrier ring, a producer warp.
//
// Replaces the TPU kernel mmlspark_tpu/parallel/flash.py:_flash_kernel for
// bfloat16 q, k, v with head_dim 64 or 128 whose base addresses are 16-byte
// aligned and whose (b, n, h) strides are multiples of 8 elements (TMA's
// rules); parallel/flash.py:flash_route sends every other call to
// flash_attn.cu. It computes what that kernel returns: out = softmax(scale *
// q k^T, masked) v for q of shape (b, n, h, d) and k, v of shape (b, nk, h,
// d), scale = 1/sqrt(d), with an online softmax in float32 over key tiles, so
// the (n, nk) scores never exist in device memory. Masked scores are -1e30
// after scaling; the result is acc / max(l, 1e-30), rounded once to bfloat16
// (nearest even). Causal masking is top-left aligned: query i sees key j when
// i >= j, both counted from 0.
//
// Arithmetic. S = q k^T is a wgmma of the raw bf16 values with float32
// accumulators (each product of two bf16 values is exact in float32), then
// multiplied in float32 by scale * log2(e): the softmax runs in base 2
// (ex2.approx), so p = 2^(x - m) with x and m in that domain. Masked scores
// are -1e30 there, which gives the TPU kernel's p = 0 (and p = 1 where a row
// has seen no key yet, as there); only the tiles that hold the diagonal or
// pass nk are masked. P V is a wgmma with P in registers, and P is split as
// P = P_hi + P_lo, P_hi = bf16(P), P_lo = bf16(P - P_hi): two wgmmas into
// one float32 accumulator, while l sums the float32 P. One bf16 rounding of
// P would be a relative error of up to 2^-8 on each weight and would miss
// the kernel's tolerance on outputs near zero; the split keeps P to within
// 2^-16 (tests/test_torch_flash_sm90.py replays the arithmetic on the CPU).
//
// Design. One CTA of three warpgroups per (batch*head, 128-row q tile),
// heaviest causal tiles launched first. Warpgroups 0 and 1 each own 64 q
// rows (wgmma's M) and walk the same key tiles. Warpgroup 2 is the producer:
// it gives up registers (setmaxnreg) and one thread issues TMA loads: the q
// tile once, then K and V tiles of 128 keys into a ring of shared-memory
// stages (3 at d=64, 2 at d=128), with a full and an empty mbarrier for
// each K and each V stage, so a stage's K is refilled while its V is still
// read. The tensor maps read (b, n, h, d) in place by strides: 4-D maps
// (d, h, n, b), innermost first, box (64 columns, 1, 128 rows, 1), 128-byte
// swizzle, so d=128 takes two column boxes per tile; the wgmma descriptors
// match that swizzle (K-major q and K; MN-major V, transposed in the
// instruction). Rows past n or nk are filled with zeros by TMA; keys past nk
// are masked. Each row of the m64 accumulator lives in a quad of 4 threads,
// so the row max and sum take 2 shuffles each. Per key tile a consumer
// issues, in one turn, S of tile t and O += P V of tile t - 1, waits for S
// alone and runs the softmax of tile t while P V still runs; the two
// consumers take turns at the tensor cores (named barriers), so one's
// softmax also overlaps the other's products. The first and last turns are
// peeled off the loop: with its wgmmas issued under conditions, ptxas
// serialised them ("wgmma.mma_async instructions are serialized"). Tiles
// wholly above the causal diagonal are skipped, which is exact (see
// flash_attn.cu). No atomics and a fixed order of every sum, so two
// launches give the same bits.
//
// What bounds it. At b=4, n=2048, h=8, d=64, causal, the function does 4*d
// operations per unmasked (query, key) pair: 17.2 GFLOP, 0.0174 ms at the
// 989 TFLOP/s dense bf16 tensor-core rate, against 0.0100 ms for its bytes.
// The hi/lo split makes it 6*d per pair (2*d for S, 2*2*d for P V): 25.8
// GFLOP, a floor of 0.0261 ms for this design, 0.667 of the function's
// bound. Besides the tensor cores, each score costs an ex2 on the special
// function units (16 per clock per SM) and about eight float32 operations,
// of the order of the wgmma time at d=64. On the H100 the kernel takes
// about 0.07 ms there (PERF.md): the d=128 time exceeds the d=64 time by
// about the extra tensor-core time, so tensor and softmax work still add
// up more than they overlap. Tried and slower (PERF.md): the next tile's S
// in a second register set during this tile's softmax (spills at 168
// registers), three consumer warpgroups of fewer registers each, fused
// scale-and-exp with partial maxima. Not done: persistent CTAs.

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_wgmma.cuh"

namespace {

constexpr int kBlockK = 128;                 // keys per K/V tile
constexpr int kBoxCols = 64;                 // bf16 columns per TMA box
constexpr int kRowBytes = kBoxCols * 2;      // 128: the swizzle span
constexpr float kNegInf = -1e30f;            // the TPU kernel's mask value
constexpr double kLog2e = 1.4426950408889634;
constexpr int kEncodeError = 100000;         // + the CUresult of an encode
constexpr int kNoEncoder = 99999;

constexpr int kProducerRegs = 40;            // setmaxnreg: 128*40 +
constexpr int kConsumerRegs = 232;           //   256*232 <= 65536

template <int D>
struct Cfg {
  // two consumer warpgroups of 64 q rows each, then a producer warpgroup
  static constexpr int kConsumers = 2;
  static constexpr int kBlockQ = 64 * kConsumers;        // q rows per CTA
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kBoxes = D / kBoxCols;            // boxes per row
  static constexpr int kQBox = kBlockQ * kRowBytes;      // one q box
  static constexpr int kKVBox = kBlockK * kRowBytes;     // one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;       // one K or V tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  // q | K[stages] | V[stages] | mbarriers: q_full, k_full[], v_full[],
  // k_empty[], v_empty[]; plus slack to align the base to 1024 bytes
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D map into shared memory; completion (bytes) is
// reported to `bar`. Coordinates innermost first: column, head, row, batch.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// Barrier addresses: q_full, then per stage k_full, v_full, k_empty, v_empty.
template <int D>
struct Bars {
  static constexpr int S = Cfg<D>::kStages;
  uint32_t base;
  __device__ __forceinline__ uint32_t q_full() const { return base; }
  __device__ __forceinline__ uint32_t full(int t, int v) const {
    return base + 8u * (1 + v * S + t % S);
  }
  __device__ __forceinline__ uint32_t empty(int t, int v) const {
    return base + 8u * (1 + (2 + v) * S + t % S);
  }
  // the round of tile t in its stage: the parity a full barrier completes
  __device__ __forceinline__ uint32_t parity(int t) const {
    return (uint32_t)((t / S) & 1);
  }
};

// The two consumer warpgroups take turns issuing their products, so that
// one's softmax runs while the other's wgmmas do: warpgroup w waits at
// named barrier kTurn + w, issues, and lets the other go (barrier 0 is
// __syncthreads').
constexpr int kTurn = 1;

__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(kTurn + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(kTurn + (cw ^ 1)) : "memory");
}

// One consumer warpgroup (cw): 64 q rows of the CTA over every key tile.
// sq: its rows of the q tile; sk, sv: the K and V stages.
template <int D>
struct Consumer {
  using C = Cfg<D>;
  static constexpr int NS = kBlockK / 2;    // score registers per thread
  static constexpr int NO = D / 2;          // output registers per thread
  static constexpr int KS = kBlockK / 16;   // k16 slices of a key tile

  uint32_t sq, sk, sv;
  Bars<D> bars;
  int cw, tiles, wrow, row, t4, lane, nk, causal;
  float scale_log2;
  float sc[NS], o[NO];
  float m0, m1, l0, l1, c0, c1;
  uint32_t phi[KS][4], plo[KS][4];

  __device__ __forceinline__ void release(int t, int v) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.empty(t, v));
  }

  // S = q K^T over D/16 slices of 16 columns (32 bytes of a 128-byte row)
  __device__ __forceinline__ void issue_scores(int t) {
    const uint32_t kb = sk + (t % C::kStages) * C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_m64n128k16_ss(
          sc, desc_sw128(sq + (kk / 4) * C::kQBox + (kk % 4) * 32, 16, 1024),
          desc_sw128(kb + (kk / 4) * C::kKVBox + (kk % 4) * 32, 16, 1024),
          kk > 0);
    }
  }

  // O += P_hi V + P_lo V, V MN-major: 16 keys of 128 bytes per slice
  __device__ __forceinline__ void issue_pv(int t) {
    const uint32_t vb = sv + (t % C::kStages) * C::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int x = 0; x < C::kBoxes; ++x) {
        const uint64_t dv = desc_sw128(
            vb + x * C::kKVBox + kk * 16 * kRowBytes, C::kKVBox, 1024);
        wgmma_m64n64k16_rs_tb(o + 32 * x, phi[kk], dv);
        wgmma_m64n64k16_rs_tb(o + 32 * x, plo[kk], dv);
      }
    }
  }

  // The online softmax of tile t in base 2 on sc, for rows row (register
  // pairs 0, 1 of each 4) and row + 8 (pairs 2, 3): scale, mask (only the
  // tiles that hold the diagonal or pass nk), m, l, the corrections c0, c1,
  // and the float32 P left in sc.
  __device__ __forceinline__ void softmax(int t) {
    const int k0 = t * kBlockK;
    if (k0 + kBlockK > nk || (causal && k0 + kBlockK - 1 > wrow)) {
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        const int key = k0 + 8 * (r / 4) + 2 * t4 + (r & 1);
        const int qr = row + 8 * ((r >> 1) & 1);
        const bool masked = key >= nk || (causal && key > qr);
        sc[r] = masked ? kNegInf : sc[r] * scale_log2;
      }
    } else {
#pragma unroll
      for (int r = 0; r < NS; ++r) sc[r] = sc[r] * scale_log2;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      if ((r >> 1) & 1) mx1 = fmaxf(mx1, sc[r]);
      else mx0 = fmaxf(mx0, sc[r]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    c0 = ex2(m0 - mx0);
    c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      if ((r >> 1) & 1) {
        sc[r] = ex2(sc[r] - mx1);
        sum1 += sc[r];
      } else {
        sc[r] = ex2(sc[r] - mx0);
        sum0 += sc[r];
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }

  // P = P_hi + P_lo as A fragments: slice kk holds score registers
  // 8kk..8kk+7, two per .b32 in the accumulator's order
  __device__ __forceinline__ void split_p() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = sc[8 * kk + 2 * j], b = sc[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hi2);
        phi[kk][j] = bits(hi2);
        plo[kk][j] = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
      }
    }
  }

  __device__ __forceinline__ void rescale() {
#pragma unroll
    for (int r = 0; r < NO; ++r) o[r] *= ((r >> 1) & 1) ? c1 : c0;
  }

  // Each turn issues S of tile t and O += P V of tile t - 1 (whose
  // correction is applied to O first); the softmax of tile t then runs
  // while P V does. The first and last turns are peeled off, so the loop
  // issues its wgmmas unconditionally. Every warpgroup takes tiles + 1
  // turns.
  __device__ __forceinline__ void run() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
    mbar_wait(bars.q_full(), 0);
    if (cw == 1) turn_pass(cw);                 // warpgroup 0 goes first
    mbar_wait(bars.full(0, 0), 0);
    turn_wait(cw);
    wgmma_fence();
    issue_scores(0);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait<0>();
    fence_operands<NS>(sc);
    release(0, 0);
    softmax(0);
    split_p();
    for (int t = 1; t < tiles; ++t) {
      mbar_wait(bars.full(t, 0), bars.parity(t));
      rescale();
      mbar_wait(bars.full(t - 1, 1), bars.parity(t - 1));
      turn_wait(cw);
      fence_operands<NO>(o);
      wgmma_fence();
      issue_scores(t);
      wgmma_commit();
      issue_pv(t - 1);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait<1>();                          // S(t); P V of t - 1 runs on
      fence_operands<NS>(sc);
      release(t, 0);
      softmax(t);
      wgmma_wait<0>();
      fence_operands<NO>(o);
      release(t - 1, 1);
      split_p();
    }
    rescale();
    mbar_wait(bars.full(tiles - 1, 1), bars.parity(tiles - 1));
    turn_wait(cw);
    fence_operands<NO>(o);
    wgmma_fence();
    issue_pv(tiles - 1);
    wgmma_commit();
    if (cw == 0) turn_pass(cw);
    wgmma_wait<0>();
    fence_operands<NO>(o);
  }

  // acc / max(l, 1e-30), rounded once to bf16; rows past n are not stored
  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ ob,
                                        long long o_sn, int n) const {
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * x + 8 * i + 2 * t4;
        const float* r = o + 32 * x + 4 * i;
        if (row < n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * o_sn +
                                             col) =
              __floats2bfloat162_rn(r[0] / den0, r[1] / den0);
        if (row + 8 < n)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row + 8) * o_sn +
                                             col) =
              __floats2bfloat162_rn(r[2] / den1, r[3] / den1);
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attn_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                       __grid_constant__ const CUtensorMap tk,
                       __grid_constant__ const CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, int h, int n, int nk,
                       long long o_sb, long long o_sn, long long o_sh,
                       float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;             // stage s: + s * tile
  const uint32_t sv = sk + S * C::kKVBytes;
  const Bars<D> bars{sq + C::kBarOffset};

  const int bi = blockIdx.x / h, hi = blockIdx.x % h;
  // the last q tiles see the most keys under a causal mask: launch them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBlockQ;
  int tiles = (nk + kBlockK - 1) / kBlockK;
  if (causal) tiles = min(tiles, (min(q0 + C::kBlockQ, n) - 1) / kBlockK + 1);

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bars.full(s, 0), 1);
      mbar_init(bars.full(s, 1), 1);
      mbar_init(bars.empty(s, 0), 4 * C::kConsumers);   // one per warp
      mbar_init(bars.empty(s, 1), 4 * C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::kConsumers) {                       // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * C::kConsumers) {
      mbar_expect_tx(bars.q_full(), C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(sq + x * C::kQBox, &tq, bars.q_full(), x * kBoxCols, hi, q0,
                 bi);
      for (int t = 0; t < tiles; ++t) {
        const uint32_t free_parity = bars.parity(t) ^ 1;
        const int stage = (t % S) * C::kKVBytes;
        mbar_wait(bars.empty(t, 0), free_parity);
        mbar_expect_tx(bars.full(t, 0), C::kKVBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sk + stage + x * C::kKVBox, &tk, bars.full(t, 0),
                   x * kBoxCols, hi, t * kBlockK, bi);
        mbar_wait(bars.empty(t, 1), free_parity);
        mbar_expect_tx(bars.full(t, 1), C::kKVBytes);
        for (int x = 0; x < C::kBoxes; ++x)
          tma_load(sv + stage + x * C::kKVBox, &tv, bars.full(t, 1),
                   x * kBoxCols, hi, t * kBlockK, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x % 32;
    Consumer<D> c;
    c.sq = sq + wg * 64 * kRowBytes;   // rows 64*wg.. of each q box
    c.sk = sk;
    c.sv = sv;
    c.bars = bars;
    c.cw = wg;
    c.tiles = tiles;
    c.wrow = q0 + wg * 64;
    c.row = c.wrow + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    c.t4 = lane % 4;
    c.lane = lane;
    c.nk = nk;
    c.causal = causal;
    c.scale_log2 = scale_log2;
    c.run();
    c.store(out + bi * o_sb + hi * o_sh, o_sn, n);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda at link time.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// geom: dims (d, h, n, b), byte strides of h, n and b, box (4), swizzle
// bytes, as parallel/flash.py:tma_geometry computes them. The kernel's
// shared-memory layout fixes the box (`rows` rows) and the swizzle:
// anything else is refused here.
int encode(CUtensorMap* map, const void* base, const long long* geom, int d,
           int rows) {
  const long long* box = geom + 7;
  if (geom[0] != d || box[0] != kBoxCols || box[1] != 1 || box[2] != rows ||
      box[3] != 1 || geom[11] != kRowBytes)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  cuuint64_t dims[4], strides[3];
  cuuint32_t boxdim[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)geom[i];
    boxdim[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)geom[4 + i];
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, boxdim, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           const long long* geom, int b, int h, int n, int nk, long long o_sb,
           long long o_sn, long long o_sh, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  int code = encode(&mq, q, geom, D, C::kBlockQ);
  if (code == 0) code = encode(&mk, k, geom + 12, D, kBlockK);
  if (code == 0) code = encode(&mv, v, geom + 24, D, kBlockK);
  if (code != 0) return code;
  const int smem = C::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h),
                  (unsigned)((n + C::kBlockQ - 1) / C::kBlockQ));
  flash_attn_sm90_kernel<D><<<grid, C::kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, h, n, nk, o_sb, o_sn, o_sh,
      (float)((double)scale * kLog2e), causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) of device `device`.
// q, k, v, out are bfloat16; geom holds 12 int64 per tensor for q, k and v
// (see encode; q's box has 192 rows at d=64 and 128 at d=128, K's and V's
// 128). out's strides are in elements and must be even (bf16 pairs are
// stored as one 4-byte word). d must be 64 or 128, n and nk positive, b * h
// below 2^31. Returns 0 on success, a CUDA error code, or 100000 + the
// CUresult of a refused tensor map.
int mmls_flash_attn_sm90(const void* q, const void* k, const void* v,
                         void* out, const long long* geom, int b, int h,
                         int n, int nk, int d, long long o_sb, long long o_sn,
                         long long o_sh, float scale, int causal, int device,
                         void* stream) {
  if ((d != 64 && d != 128) || n < 1 || nk < 1 ||
      (long long)b * h >= (1LL << 31) || (o_sb | o_sn | o_sh) & 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 64)
    return launch<64>(q, k, v, out, geom, b, h, n, nk, o_sb, o_sn, o_sh,
                      scale, causal, s);
  return launch<128>(q, k, v, out, geom, b, h, n, nk, o_sb, o_sn, o_sh,
                     scale, causal, s);
}

const char* mmls_cuda_error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor map (the code less "
           "100000 is its CUresult)";
  if (code == kNoEncoder)
    return "cuTensorMapEncodeTiled was not found in the CUDA driver";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

// Tensor-core attention forward for Hopper (sm_90a): bfloat16 q, k, v,
// float32 scores, statistics and accumulator, bfloat16 output.  The body of
// the bfloat16 launches of flash_attention.cu (flash_attention_fwd_wgmma)
// and of flash_attention_bwd.cu's forward with statistics
// (flash_attention_fwd_stats_wgmma), for head dims d % 16 == 0, d <= 256.
// Float32 and other head dims keep the CUDA-core body (attention_tile.cuh).
//
// Replaces the TPU kernels
//   _fwd_kernel        src/repro/kernels/flash_attention.py:25     (pallas_call :89)
//   _fwd_stats_kernel  src/repro/kernels/flash_attention_bwd.py:27 (pallas_call :147)
// Same function: q (B,Hq,T,d) against k, v (B,Hkv,S,d); query head h reads
// kv head h / (Hq/Hkv); s = (q.k) * scale; causal mask kpos <= qpos
// (top-left aligned); float32 online softmax; the denominator clamped at
// 1e-30; o in bfloat16; with statistics, the running max m (natural-log
// units of s) and l = max(l, 1e-30) per query row, from which the dQ and
// dK/dV kernels recompute p = exp(s - m) / l.
//
// Bound.  4*d flops per visible (query, key) pair on the bf16 tensor cores
// (989 TFLOP/s) against q, k, v read once and o written once (3.35 TB/s):
//   dense prefill (8,15,512,64), GQA 3:1:  4.03 GFLOP 0.0041 ms, 21.0 MB 0.0063 ms (bytes)
//   hybrid prefill (8,32,1024,80), MHA:   43.0 GFLOP 0.0435 ms, 167.8 MB 0.0501 ms (bytes)
//   train step (8,15,1024,64) with m, l:  16.1 GFLOP 0.0163 ms (operations), 42.9 MB 0.0128 ms
// The work sits at the card's balance point: neither the CUDA cores (67
// TFLOP/s float32) nor shared-memory operand reads can come near it, so the
// products run on wgmma and the tiles arrive by TMA.
//
// Design.
//  * One block per (b*Hq + h, 128-row query tile): two consumer warpgroups
//    of 64 query rows each and one producer warp (288 threads; from d = 224
//    on, one warpgroup and 64 rows, where the registers allow no more).
//    Query tiles are launched longest first (blockIdx.y reversed), so the
//    causal walk's last wave is its shortest.
//  * TMA.  Q (once) and the K/V tiles come in by cp.async.bulk.tensor through
//    4-D maps (d, rows, heads, batch) over the tensors' real strides, so the
//    model's (B,T,H,d) projections are read in place.  K/V tiles cycle
//    through a ring of 2-3 stages, each with a full mbarrier (TMA bytes) and
//    an empty one (one arrival per consumer warp after its P.V).  A tile is
//    stored as d/W column blocks of W = 64, 32 or 16 columns (the largest
//    dividing d), swizzled 128, 64 or 32 bytes to match, so d = 80 is five
//    32-byte blocks.  TMA zero-fills rows past T or S.
//  * wgmma.  S = Q.K^T is m64nBKk16 with Q and K from shared memory
//    (K-major), summed over d/16 steps into float32 registers.  O += P.V takes
//    P from registers (the S accumulator's layout is the A fragment's,
//    rounded to bf16) and V from shared memory as stored: (keys, d) is
//    MN-major for this product, read through the descriptor's transpose bit,
//    never copied.  O's d/2 float32 registers per thread are updated in
//    chunks of 64, 32 and 16 columns.
//  * Masking in registers.  Keys past S (TMA's zero rows give s = 0, not
//    -inf) and, on the diagonal tile, keys past the row are set to -inf in
//    the accumulator; a warpgroup skips key tiles wholly above its rows; the
//    block's walk stops at the tile holding its last query row; a short last
//    query tile is masked on store.
//  * Softmax in exp2: the scores are scaled by scale*log2(e) in registers,
//    the running max is kept in those units and written as m = max * ln(2),
//    in s's natural-log units.  l sums the float32 p; P.V multiplies p
//    rounded to bf16 (the TPU kernel multiplies float32 p).
//  * Determinism.  Tiles depend on d alone, each block walks its keys in
//    fixed order, nothing uses atomics: row b of a batched launch is bitwise
//    equal to a solo launch of row b, and strided views equal contiguous
//    inputs.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_wgmma {

constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile shape for head dim D (a multiple of 16, at most 256).  Two consumer
// warpgroups where their registers fit the 168 a thread that 288 threads
// allow; from d = 224 on, O alone takes 112+ registers, so one warpgroup
// (160 threads, up to 255 registers).
template <int D>
struct Tile {
  static constexpr int WGS = D <= 208 ? 2 : 1;            // consumer warpgroups
  static constexpr int BQ = 64 * WGS;                      // query rows per block
  static constexpr int THREADS = 128 * WGS + 32;           // + one producer warp
  static constexpr int BK = D <= 128 ? 128 : 64;          // key rows per tile
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int ROW = W * 2;                        // bytes per row of a column block
  static constexpr int SWIZZLE = W == 64 ? 1 : (W == 32 ? 2 : 3);   // descriptor layout type
  static constexpr int QBYTES = BQ * D * 2;
  static constexpr int KVBYTES = BK * D * 2;               // one K or one V tile
  static constexpr int BARRIERS = 8 * (1 + 2 * 3);
  static constexpr int STAGES =
      1024 + QBYTES + 3 * 2 * KVBYTES + BARRIERS <= static_cast<int>(kMaxSmem) ? 3 : 2;
  static constexpr size_t SMEM = 1024 + QBYTES + STAGES * 2 * KVBYTES + BARRIERS;
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static_assert(SMEM <= kMaxSmem, "shared memory");
};

// ---------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the points where asynchronous wgmma starts and is waited on.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, float32) = or += A (64 x 16) . B (16 x N).  `ss`: A and B from
// shared memory, both K-major.  `rs`: A from registers (four bf16 pairs per
// thread), B MN-major (transposed) from shared memory, always accumulating.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out, int Hq, int group,
               int T, int S, int causal, float scale) {
  using C = Tile<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1 KB
  const uint32_t skv = sq + C::QBYTES;      // stage s: K at skv + 2s*KVBYTES, V after it
  const uint32_t qfull = skv + C::STAGES * 2 * C::KVBYTES;
  const uint32_t full0 = qfull + 8;         // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;   // longest causal tiles first
  const int nrows = T - q0 < C::BQ ? T - q0 : C::BQ;
  int nkeys = S;
  if (causal && q0 + nrows < S) nkeys = q0 + nrows;
  const int ntiles = (nkeys + BK - 1) / BK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, C::WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::WGS * 4) {
    // producer: Q once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(qfull, C::QBYTES);
#pragma unroll
      for (int c = 0; c < D / C::W; ++c) {
        tma_load_4d(sq + c * C::BQ * C::ROW, &qmap, qfull, c * C::W, q0, h, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sk = skv + 2 * s * C::KVBYTES;
        mbar_expect_tx(full, 2 * C::KVBYTES);
#pragma unroll
        for (int c = 0; c < D / C::W; ++c) {
          tma_load_4d(sk + c * BK * C::ROW, &kmap, full, c * C::W, it * BK, kvh, b);
          tma_load_4d(sk + C::KVBYTES + c * BK * C::ROW, &vmap, full, c * C::W, it * BK, kvh,
                      b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows r0 .. r0 + 63
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + (warp & 3) * 16 + g, r0 + (warp & 3) * 16 + g + 8};
  const int last_row = r0 + 63 < T - 1 ? r0 + 63 : T - 1;
  const bool active = r0 < T;
  const float c = scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float mx[2] = {-1e30f, -1e30f};   // running max of s * log2(e)
  float lsum[2] = {0.0f, 0.0f};     // this thread's share of the denominator

  mbar_wait(qfull, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
    const int j0 = it * BK;
    if (active && (!causal || j0 <= last_row)) {
      const uint32_t sk = skv + 2 * s * C::KVBYTES;
      const uint32_t sv = sk + C::KVBYTES;

      // S = Q K^T over d in steps of 16
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
      fence_regs<BK / 2>(sc);
      wgmma_fence();
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        const uint32_t off = (k0 % C::W) * 2;   // inside a swizzled row
        const uint64_t da = make_desc(sq + (k0 / C::W) * C::BQ * C::ROW + wg * 64 * C::ROW + off,
                                      16, 8 * C::ROW, C::SWIZZLE);
        const uint64_t db = make_desc(sk + (k0 / C::W) * BK * C::ROW + off, 16, 8 * C::ROW,
                                      C::SWIZZLE);
        if constexpr (BK == 128) {
          wgmma_ss_n128(sc, da, db, k0 > 0);
        } else {
          wgmma_ss_n64(sc, da, db, k0 > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);

      // s * scale in log2 units; keys past S, and past the row on the
      // diagonal, to -inf
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= c;
      if (j0 + BK > S || (causal && j0 + BK - 1 > r0)) {
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + n8 * 8 + 2 * t4 + (e & 1);
            if (key >= S || (causal && key > row[e >> 1])) {
              sc[n8 * 4 + e] = __int_as_float(0xff800000);   // -inf
            }
          }
        }
      }

      // online softmax: each row lives on the four threads of a quad
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m = mx[i];
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8) {
          m = fmaxf(m, fmaxf(sc[n8 * 4 + 2 * i], sc[n8 * 4 + 2 * i + 1]));
        }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float alpha = ex2(mx[i] - m);
        mx[i] = m;
        float sum = 0.0f;
#pragma unroll
        for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(sc[n8 * 4 + 2 * i + e] - m);
            sc[n8 * 4 + 2 * i + e] = p;
            sum += p;
          }
        }
        lsum[i] = lsum[i] * alpha + sum;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          acc[n8 * 4 + 2 * i] *= alpha;
          acc[n8 * 4 + 2 * i + 1] *= alpha;
        }
      }

      // P (bf16) as the A fragments of the P.V product, 16 keys each
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        }
      }

      // O += P V, V read MN-major in chunks of 64, 32, 16 columns
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t vk = sv + kk * 16 * C::ROW;
#pragma unroll
        for (int n0 = 0; n0 + 64 <= D; n0 += 64) {
          wgmma_rs_n64(acc + n0 / 2, pa[kk],
                       make_desc(vk + (n0 / C::W) * BK * C::ROW, BK * C::ROW, 8 * C::ROW,
                                 C::SWIZZLE));
        }
        if constexpr (D % 64 >= 32) {
          constexpr int n0 = D / 64 * 64;
          wgmma_rs_n32(acc + n0 / 2, pa[kk],
                       make_desc(vk + (n0 / C::W) * BK * C::ROW, BK * C::ROW, 8 * C::ROW,
                                 C::SWIZZLE));
        }
        if constexpr (D % 32 == 16) {
          constexpr int n0 = D - 16;
          wgmma_rs_n16(acc + n0 / 2, pa[kk],
                       make_desc(vk + (n0 / C::W) * BK * C::ROW, BK * C::ROW, 8 * C::ROW,
                                 C::SWIZZLE));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(acc);
    }
    // release the stage: one arrival per consumer warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lsum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (row[i] >= T) continue;
    const float inv = 1.0f / l;
    const long long out_row = static_cast<long long>(bh) * T + row[i];
    __nv_bfloat16* orow = o + out_row * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * t4) =
          pack_bf16(acc[n8 * 4 + 2 * i] * inv, acc[n8 * 4 + 2 * i + 1] * inv);
    }
    if (m_out != nullptr && t4 == 0) {
      m_out[out_row] = mx[i] * kLn2;   // natural-log units of s
      l_out[out_row] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up in the libcuda the CUDA
// runtime has loaded, so the build needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D map (d, rows, heads, batch) of bfloat16 over element strides (row,
// head, batch), boxes of `w` columns by `box_rows` rows, swizzled 2w bytes.
// An axis of size 1 gets a packed stride (its stride is never used).
inline bool make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads, int batch,
                     long long s_row, long long s_head, long long s_batch, int w,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                           static_cast<cuuint64_t>(s_head) * 2,
                           static_cast<cuuint64_t>(s_batch) * 2};
  if (rows == 1) strides[0] = static_cast<cuuint64_t>(d) * 2;
  if (heads == 1) strides[1] = strides[0] * rows;
  if (batch == 1) strides[2] = strides[1] * heads;
  cuuint32_t box[4] = {static_cast<cuuint32_t>(w), static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* m, float* l, int B,
             int Hq, int Hkv, int T, int S, const long long* st, int causal, float scale,
             cudaStream_t stream) {
  using C = Tile<D>;
  CUtensorMap qmap, kmap, vmap;
  if ((T + C::BQ - 1) / C::BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (!make_map(&qmap, q, D, T, Hq, B, st[2], st[1], st[0], C::W, C::BQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S > 0) {
    if (!make_map(&kmap, k, D, S, Hkv, B, st[5], st[4], st[3], C::W, C::BK) ||
        !make_map(&vmap, v, D, S, Hkv, B, st[8], st[7], st[6], C::W, C::BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    kmap = qmap;   // no key tiles are loaded
    vmap = qmap;
  }
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (T + C::BQ - 1) / C::BQ);
  fwd_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), m, l, Hq, Hq / Hkv, T, S, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 forward: q (B,Hq,T,d), k, v (B,Hkv,S,d) with element strides
// st = (q: b, h, t; k: b, h, t; v: b, h, t), each last axis contiguous,
// base addresses and strides 16-byte aligned (the wrapper checks); o
// contiguous (B,Hq,T,d); m, l contiguous (B,Hq,T) float32, or null for the
// forward without statistics.  Returns a CUDA error code.
inline int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                  int B, int Hq, int Hkv, int T, int S, int d, const long long* st, int causal,
                  float scale, cudaStream_t stream) {
  if (B < 0 || T < 0 || S < 0 || Hkv <= 0 || Hq % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Hq == 0 || T == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(B) * Hq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
#define ATTN_WGMMA_CASE(DD) \
  case DD:                  \
    return launch_d<DD>(q, k, v, o, m, l, B, Hq, Hkv, T, S, st, causal, scale, stream);
    ATTN_WGMMA_CASE(16) ATTN_WGMMA_CASE(32) ATTN_WGMMA_CASE(48) ATTN_WGMMA_CASE(64)
    ATTN_WGMMA_CASE(80) ATTN_WGMMA_CASE(96) ATTN_WGMMA_CASE(112) ATTN_WGMMA_CASE(128)
    ATTN_WGMMA_CASE(144) ATTN_WGMMA_CASE(160) ATTN_WGMMA_CASE(176) ATTN_WGMMA_CASE(192)
    ATTN_WGMMA_CASE(208) ATTN_WGMMA_CASE(224) ATTN_WGMMA_CASE(240) ATTN_WGMMA_CASE(256)
#undef ATTN_WGMMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace attn_wgmma

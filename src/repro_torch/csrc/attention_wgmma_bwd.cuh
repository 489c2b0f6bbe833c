// Tensor-core attention backward for Hopper (sm_90a): bfloat16 q, k, v and
// dO, float32 statistics (m, l, delta), scores and accumulators, bfloat16
// gradients.  The bodies of flash_attention_bwd.cu's bfloat16 launches
// (flash_attention_dq_wgmma, flash_attention_dkv_wgmma) for head dims
// d % 16 == 0, 16 <= d <= 128.  Float32 and other head dims keep the
// CUDA-core bodies (dq_kernel, dkv_kernel in flash_attention_bwd.cu).
//
// Replaces the TPU kernels
//   _dq_kernel   src/repro/kernels/flash_attention_bwd.py:65 (pallas_call :205)
//   _dkv_kernel  src/repro/kernels/flash_attention_bwd.py:96 (pallas_call :218)
// Same functions: q, dO (B,Hq,T,d) against k, v (B,Hkv,S,d); query head h
// reads kv head h / (Hq/Hkv); causal mask kpos <= qpos (top-left aligned);
// p = exp(s - m) / l recomputed on the visible pairs from the forward's m
// (natural-log units of s = (q.k) * scale) and l; delta = sum(dO * O) per
// query row (formed by the wrapper);
//   dS = p * (dO.V^T - delta),  dQ = dS.K * scale,  dK = dS^T.Q * scale,
//   dV = p^T.dO,
// dK and dV summed over the g query heads of each kv head.
//
// Bound.  2*d flops per product per visible (query, key) pair on the bf16
// tensor cores (989 TFLOP/s): three products in dQ (q.k, dO.v, dS.k), four in
// dK/dV (k.q, v.dO, p^T.dO, dS^T.q), against the inputs read once and the
// outputs written once (3.35 TB/s).  At the SmolLM-360M train step, q (8,15,
// 1024,64) against k, v (8,5,1024,64), causal:
//   dQ:    24.18 GFLOP 0.0245 ms (operations), 59.2 MB 0.0177 ms
//   dK/dV: 32.24 GFLOP 0.0326 ms (operations), 53.9 MB 0.0161 ms
// Both sit at the card's balance point, as the forward does: the products run
// on wgmma and the tiles arrive by TMA (the CUDA-core bodies read two shared
// operands per float32 fused multiply-add and run ~190x their bounds).
//
// Design.  The forward's machinery (attention_wgmma.cuh): a producer warp
// with an mbarrier ring fed by TMA through 4-D maps over the real strides,
// tiles as swizzled column blocks of 64/32/16 columns (any d % 16 == 0),
// `ss` products with both operands K-major, `rs` products with A from
// registers and B read MN-major through the descriptor's transpose bit, and
// masks applied in registers.
//  * dQ: one block per (b*Hq + h, 128 query rows): two consumer warpgroups
//    of 64 rows and one producer warp (288 threads).  Q and dO come in once;
//    64-key K/V tiles cycle through a ring of 3 stages.  Each thread keeps
//    its two rows' m*log2(e), 1/l and delta in registers.  Per key tile:
//    S = Q.K^T and dP = dO.V^T (`ss`, issued together), p = exp2(S*scale*
//    log2(e) - m*log2(e)) / l, dS = p * (dP - delta) in float32, then
//    dQ += dS.K (`rs`: dS rounded to bf16 as the A fragment, K read
//    MN-major).  `scale` is applied once on store.  The walk stops at the tile
//    holding the block's last row; blocks launch longest walk first.
//  * dK/dV: one block per (b*Hkv + kv head, key tile): keys are the M side.
//    K and V come in once; a 3-stage ring of (Q, dO) tiles of 64 query rows, each
//    stage with its rows' m*log2(e), 1/l and delta (written by the producer
//    warp's 32 lanes with plain loads; the stage's full barrier takes their
//    32 arrivals and the TMA bytes).  The block walks the group's g query
//    heads in fixed order and, for each, the query tiles from the one holding
//    its first key.  Per tile: S^T = K.Q^T and dP^T = V.dO^T (`ss`),
//    P^T with the statistics per column, dV += P^T.dO (`rs`, P rounded to
//    bf16, dO MN-major), dS^T = P^T * (dP^T - delta), dK += dS^T.Q (`rs`, Q
//    MN-major).  dK and dV stay in float32 registers across the whole GQA
//    group and are rounded once.  Key tile 0 walks longest and launches
//    first.
//  * Masking in registers.  Keys past S (TMA's zero rows give s = 0, and
//    p = exp(-m)/l there, not 0), queries past T and, on diagonal tiles,
//    keys past the query are set to p = 0 before dS; a warpgroup skips tiles
//    wholly above its rows; rows past T or S are masked on store.
//
// Registers.  A thread of a consumer warpgroup holds, in float32, a 64 x N
// product's N/2 values.  The 288 threads of two warpgroups allow 168 a
// thread, one warpgroup (160 threads) 255.
//  * dQ, 64-key tiles: S 32 + dP 32 + dQ d/2 (32 at d = 64, 64 at d = 128),
//    at most 128 live during the products: two warpgroups at every d <= 128.
//  * dK/dV, 64-query tiles: dK d/2 + dV d/2 + S^T 32 + dP^T 32: 128 at
//    d = 64 (two warpgroups, 128 keys a block); from d = 80 on, 144-192, so
//    one warpgroup of 64 keys (160 threads).
// Above d = 128 dK and dV alone take 144+ registers: those head dims, and
// float32, stay on the CUDA-core bodies (flash_bwd_route in the wrapper).
//
// Determinism.  Tiles depend on d alone, every block walks its tiles in fixed
// order and writes each output element once, nothing uses atomics: row b of a
// batched launch is bitwise equal to a solo launch of row b, and strided
// views equal contiguous inputs.
#pragma once

#include "attention_wgmma.cuh"

namespace attn_wgmma_bwd {

using attn_wgmma::ex2;
using attn_wgmma::fence_regs;
using attn_wgmma::kLog2e;
using attn_wgmma::kMaxSmem;
using attn_wgmma::make_desc;
using attn_wgmma::make_map;
using attn_wgmma::mbar_arrive;
using attn_wgmma::mbar_expect_tx;
using attn_wgmma::mbar_init;
using attn_wgmma::mbar_wait;
using attn_wgmma::pack_bf16;
using attn_wgmma::smem_u32;
using attn_wgmma::tma_load_4d;
using attn_wgmma::wgmma_commit;
using attn_wgmma::wgmma_fence;
using attn_wgmma::wgmma_wait_all;

constexpr int kMaxD = 128;

// How a row of D bf16 values is stored: the forward's column blocks.
template <int D>
struct Cols {
  static constexpr int W = attn_wgmma::Tile<D>::W;              // columns per block
  static constexpr int ROW = attn_wgmma::Tile<D>::ROW;          // bytes per row of a block
  static constexpr int SWIZZLE = attn_wgmma::Tile<D>::SWIZZLE;  // descriptor layout type
  static_assert(D % 16 == 0 && D >= 16 && D <= kMaxD, "head dim");
};

template <int D>
struct DqTile : Cols<D> {
  static constexpr int BQ = 128;                 // two warpgroups of 64 query rows
  static constexpr int THREADS = 2 * 128 + 32;   // + one producer warp
  static constexpr int BK = 64;                  // key rows per tile
  static constexpr int QBYTES = BQ * D * 2;      // Q or dO
  static constexpr int KVBYTES = BK * D * 2;     // one K or one V tile
  static constexpr int BARRIERS = 8 * (1 + 2 * 3);
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = 1024 + 2 * QBYTES + STAGES * 2 * KVBYTES + BARRIERS;
  static_assert(SMEM <= kMaxSmem, "shared memory");
};

template <int D>
struct DkvTile : Cols<D> {
  static constexpr int WGS = D <= 64 ? 2 : 1;    // consumer warpgroups
  static constexpr int BKEY = 64 * WGS;          // key rows per block
  static constexpr int THREADS = 128 * WGS + 32;
  static constexpr int BQ = 64;                  // query rows per tile
  static constexpr int KBYTES = BKEY * D * 2;    // K or V
  static constexpr int QBYTES = BQ * D * 2;      // one Q or one dO tile
  static constexpr int STATS = 3 * BQ * 4;       // m*log2(e), 1/l, delta of a tile
  static constexpr int BARRIERS = 8 * (1 + 2 * 3);
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = 1024 + 2 * KBYTES + STAGES * (2 * QBYTES + STATS) + BARRIERS;
  static_assert(SMEM <= kMaxSmem, "shared memory");
};

// ---------------------------------------------------------------------------
// the two products
// ---------------------------------------------------------------------------

// acc (64 x 64) = A.B^T over D, both K-major in shared memory: A is rows
// a_row0 .. a_row0 + 63 of a tile of AROWS rows, B a tile of 64 rows.
template <int D, int AROWS>
__device__ __forceinline__ void ss_n64(float* acc, uint32_t a_tile, int a_row0, uint32_t b_tile) {
  using C = Cols<D>;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    const uint32_t off = (k0 % C::W) * 2;   // inside a swizzled row
    const uint64_t da = make_desc(a_tile + (k0 / C::W) * AROWS * C::ROW + a_row0 * C::ROW + off,
                                  16, 8 * C::ROW, C::SWIZZLE);
    const uint64_t db = make_desc(b_tile + (k0 / C::W) * 64 * C::ROW + off, 16, 8 * C::ROW,
                                  C::SWIZZLE);
    attn_wgmma::wgmma_ss_n64(acc, da, db, k0 > 0);
  }
}

// acc (64 x D) += A (64 x 16*KK, bf16 fragments in registers) . B, where B is
// a tile of ROWS >= 16*KK rows stored as column blocks; its rows are the
// product's K side, read MN-major through the transpose bit, in chunks of
// 64, 32 and 16 columns.
template <int D, int ROWS, int KK>
__device__ __forceinline__ void rs_mn(float* acc, const uint32_t (*a)[4], uint32_t b_tile) {
  using C = Cols<D>;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t bk = b_tile + kk * 16 * C::ROW;
#pragma unroll
    for (int n0 = 0; n0 + 64 <= D; n0 += 64) {
      attn_wgmma::wgmma_rs_n64(acc + n0 / 2, a[kk],
                               make_desc(bk + (n0 / C::W) * ROWS * C::ROW, ROWS * C::ROW,
                                         8 * C::ROW, C::SWIZZLE));
    }
    if constexpr (D % 64 >= 32) {
      constexpr int n0 = D / 64 * 64;
      attn_wgmma::wgmma_rs_n32(acc + n0 / 2, a[kk],
                               make_desc(bk + (n0 / C::W) * ROWS * C::ROW, ROWS * C::ROW,
                                         8 * C::ROW, C::SWIZZLE));
    }
    if constexpr (D % 32 == 16) {
      constexpr int n0 = D - 16;
      attn_wgmma::wgmma_rs_n16(acc + n0 / 2, a[kk],
                               make_desc(bk + (n0 / C::W) * ROWS * C::ROW, ROWS * C::ROW,
                                         8 * C::ROW, C::SWIZZLE));
    }
  }
}

// A 64 x 64 float32 accumulator, rounded to bf16, as the A fragments of a
// product over its 64 columns (16 each): the accumulator's layout is the A
// fragment's.
__device__ __forceinline__ void to_frags(const float* x, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*Hq + h, 128 query rows), key tiles innermost
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
              const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
              const float* __restrict__ m, const float* __restrict__ l,
              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Hq, int group,
              int T, int S, int causal, float scale) {
  using C = DqTile<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1 KB
  const uint32_t sdo = sq + C::QBYTES;
  const uint32_t skv = sdo + C::QBYTES;     // stage s: K at skv + 2s*KVBYTES, V after it
  const uint32_t qfull = skv + C::STAGES * 2 * C::KVBYTES;
  const uint32_t full0 = qfull + 8;         // full[s] = full0 + 8s
  const uint32_t empty0 = full0 + 8 * C::STAGES;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;   // longest causal walks first
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
      mbar_init(empty0 + 8 * s, 2 * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 2 * 4) {
    // producer: Q and dO once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(qfull, 2 * C::QBYTES);
#pragma unroll
      for (int c = 0; c < D / C::W; ++c) {
        tma_load_4d(sq + c * C::BQ * C::ROW, &qmap, qfull, c * C::W, q0, h, b);
        tma_load_4d(sdo + c * C::BQ * C::ROW, &domap, qfull, c * C::W, q0, h, b);
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
  float mlog[2], linv[2], dl[2];   // m*log2(e), 1/l, delta of this thread's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = row[i] < T;
    const long long idx = static_cast<long long>(bh) * T + (ok ? row[i] : 0);
    mlog[i] = ok ? m[idx] * kLog2e : 0.0f;
    linv[i] = ok ? 1.0f / l[idx] : 1.0f;
    dl[i] = ok ? delta[idx] : 0.0f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(qfull, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
    const int j0 = it * BK;
    if (active && (!causal || j0 <= last_row)) {
      const uint32_t sk = skv + 2 * s * C::KVBYTES;
      const uint32_t sv = sk + C::KVBYTES;

      // S = Q K^T and dP = dO V^T, one commit group
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.0f;
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);
      wgmma_fence();
      ss_n64<D, C::BQ>(sc, sq, 64 * wg, sk);
      ss_n64<D, C::BQ>(dp, sdo, 64 * wg, sv);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);

      // p on the visible pairs (keys past S, and past the row on the
      // diagonal, to 0), then dS = p * (dP - delta) in place of dP
      const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > r0);
#pragma unroll
      for (int n8 = 0; n8 < BK / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = ex2(sc[n8 * 4 + e] * c - mlog[i]) * linv[i];
          if (edge) {
            const int key = j0 + n8 * 8 + 2 * t4 + (e & 1);
            if (key >= S || (causal && key > row[i])) p = 0.0f;
          }
          dp[n8 * 4 + e] = p * (dp[n8 * 4 + e] - dl[i]);
        }
      }
      uint32_t dsa[BK / 16][4];
      to_frags(dp, dsa);

      // dQ += dS K, K read MN-major
      fence_regs<D / 2>(acc);
      wgmma_fence();
      rs_mn<D, BK, BK / 16>(acc, dsa, sk);
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
    if (row[i] >= T) continue;
    __nv_bfloat16* orow = dq + (static_cast<long long>(bh) * T + row[i]) * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * t4) =
          pack_bf16(acc[n8 * 4 + 2 * i] * scale, acc[n8 * 4 + 2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (b*Hkv + kv head, key tile), query heads and tiles
// innermost
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DkvTile<D>::THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ m, const float* __restrict__ l,
               const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int T, int S, int causal,
               float scale) {
  using C = DkvTile<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + C::KBYTES;
  const uint32_t sqd = sv + C::KBYTES;        // stage s: Q at sqd + 2s*QBYTES, dO after it
  const uint32_t sst = sqd + C::STAGES * 2 * C::QBYTES;   // stage s: its statistics
  const uint32_t kvfull = sst + C::STAGES * C::STATS;
  const uint32_t full0 = kvfull + 8;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  float* const stats = reinterpret_cast<float*>(smem_raw + (sst - raw));

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * C::BKEY;   // key tile 0, the longest causal walk, first
  // causal: query rows before k0 see none of this block's keys
  const int first_q = causal ? k0 / BQ * BQ : 0;
  const int nqt = T > first_q ? (T - first_q + BQ - 1) / BQ : 0;
  const int nitems = group * nqt;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);   // the producer's 32 lanes (one with the TMA bytes)
      mbar_init(empty0 + 8 * s, C::WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::WGS * 4) {
    // producer: K and V once, then the ring of (Q, dO, statistics)
    if (lane == 0) {
      mbar_expect_tx(kvfull, 2 * C::KBYTES);
#pragma unroll
      for (int c = 0; c < D / C::W; ++c) {
        tma_load_4d(sk + c * C::BKEY * C::ROW, &kmap, kvfull, c * C::W, k0, kvh, b);
        tma_load_4d(sv + c * C::BKEY * C::ROW, &vmap, kvfull, c * C::W, k0, kvh, b);
      }
    }
    for (int it = 0; it < nitems; ++it) {
      const int s = it % C::STAGES;
      const int i = it / nqt;
      const int q0 = first_q + (it - i * nqt) * BQ;
      const int h = kvh * group + i;
      mbar_wait(empty0 + 8 * s, ((it / C::STAGES) & 1) ^ 1);
      float* st = stats + s * 3 * BQ;
      const long long row0 = static_cast<long long>(b * Hq + h) * T + q0;
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q0 + r < T;
        st[r] = ok ? m[row0 + r] * kLog2e : 0.0f;
        st[BQ + r] = ok ? 1.0f / l[row0 + r] : 1.0f;
        st[2 * BQ + r] = ok ? delta[row0 + r] : 0.0f;
      }
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        const uint32_t sq = sqd + 2 * s * C::QBYTES;
        mbar_expect_tx(full, 2 * C::QBYTES);   // lane 0's arrival
#pragma unroll
        for (int c = 0; c < D / C::W; ++c) {
          tma_load_4d(sq + c * BQ * C::ROW, &qmap, full, c * C::W, q0, h, b);
          tma_load_4d(sq + C::QBYTES + c * BQ * C::ROW, &domap, full, c * C::W, q0, h, b);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns key rows kr0 .. kr0 + 63
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kr0 = k0 + 64 * wg;
  const int key[2] = {kr0 + (warp & 3) * 16 + g, kr0 + (warp & 3) * 16 + g + 8};
  const bool active = kr0 < S;
  const float c = scale * kLog2e;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(kvfull, 0);
  for (int it = 0; it < nitems; ++it) {
    const int s = it % C::STAGES;
    const int q0 = first_q + (it % nqt) * BQ;
    mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
    if (active && (!causal || q0 + BQ - 1 >= kr0)) {
      const uint32_t sq = sqd + 2 * s * C::QBYTES;
      const uint32_t sdo = sq + C::QBYTES;

      // S^T = K Q^T and dP^T = V dO^T, one commit group
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);
      wgmma_fence();
      ss_n64<D, C::BKEY>(st, sk, 64 * wg, sq);
      ss_n64<D, C::BKEY>(dpt, sv, 64 * wg, sdo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BQ / 2>(st);
      fence_regs<BQ / 2>(dpt);

      // P^T with the statistics of each column (query); queries past T, and
      // keys past the query, to 0; dS^T = P^T * (dP^T - delta) in place of dP^T
      const float* mst = stats + s * 3 * BQ;
      const bool edge = q0 + BQ > T || (causal && q0 < kr0 + 63);
#pragma unroll
      for (int n8 = 0; n8 < BQ / 8; ++n8) {
        const int col = n8 * 8 + 2 * t4;
        const float2 ml = *reinterpret_cast<const float2*>(mst + col);
        const float2 li = *reinterpret_cast<const float2*>(mst + BQ + col);
        const float2 de = *reinterpret_cast<const float2*>(mst + 2 * BQ + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e & 1;
          float p = ex2(st[n8 * 4 + e] * c - (j ? ml.y : ml.x)) * (j ? li.y : li.x);
          if (edge) {
            const int qq = q0 + col + j;
            if (qq >= T || (causal && key[e >> 1] > qq)) p = 0.0f;
          }
          st[n8 * 4 + e] = p;
          dpt[n8 * 4 + e] = p * (dpt[n8 * 4 + e] - (j ? de.y : de.x));
        }
      }
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      to_frags(st, pa);
      to_frags(dpt, dsa);

      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      wgmma_fence();
      rs_mn<D, BQ, BQ / 16>(dva, pa, sdo);
      rs_mn<D, BQ, BQ / 16>(dka, dsa, sq);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
    }
    // release the stage: one arrival per consumer warp
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const long long out = (static_cast<long long>(bkv) * S + key[i]) * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<uint32_t*>(dk + out + n8 * 8 + 2 * t4) =
          pack_bf16(dka[n8 * 4 + 2 * i] * scale, dka[n8 * 4 + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + out + n8 * 8 + 2 * t4) =
          pack_bf16(dva[n8 * 4 + 2 * i], dva[n8 * 4 + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launches
// ---------------------------------------------------------------------------

// The four maps: q and dO (d, T, Hq, B) in boxes of qrows rows, k and v
// (d, S, Hkv, B) in boxes of krows rows; st as for launch_dq.
template <int D>
bool make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v, const void* dout,
               int B, int Hq, int Hkv, int T, int S, const long long* st, int qrows, int krows) {
  constexpr int W = Cols<D>::W;
  if (!make_map(&maps[2], k, D, S, Hkv, B, st[5], st[4], st[3], W, krows) ||
      !make_map(&maps[3], v, D, S, Hkv, B, st[8], st[7], st[6], W, krows)) {
    return false;
  }
  if (T == 0) {   // no query tiles are loaded
    maps[0] = maps[1] = maps[2];
    return true;
  }
  return make_map(&maps[0], q, D, T, Hq, B, st[2], st[1], st[0], W, qrows) &&
         make_map(&maps[1], dout, D, T, Hq, B, st[11], st[10], st[9], W, qrows);
}

template <int D>
int launch_dq_d(const void* q, const void* k, const void* v, const void* dout, const float* m,
                const float* l, const float* delta, void* dq, int B, int Hq, int Hkv, int T,
                int S, const long long* st, int causal, float scale, cudaStream_t stream) {
  using C = DqTile<D>;
  const int ny = (T + C::BQ - 1) / C::BQ;
  CUtensorMap maps[4];
  if (ny > 65535 || !make_maps<D>(maps, q, k, v, dout, B, Hq, Hkv, T, S, st, C::BQ, C::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3(B * Hq, ny), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], m, l, delta, static_cast<__nv_bfloat16*>(dq), Hq,
      Hq / Hkv, T, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_d(const void* q, const void* k, const void* v, const void* dout, const float* m,
                 const float* l, const float* delta, void* dk, void* dv, int B, int Hq, int Hkv,
                 int T, int S, const long long* st, int causal, float scale,
                 cudaStream_t stream) {
  using C = DkvTile<D>;
  const int ny = (S + C::BKEY - 1) / C::BKEY;
  CUtensorMap maps[4];
  if (ny > 65535 || !make_maps<D>(maps, q, k, v, dout, B, Hq, Hkv, T, S, st, C::BQ, C::BKEY)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<D><<<dim3(B * Hkv, ny), C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], m, l, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hkv, T, S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

inline bool bad_args(int B, int Hq, int Hkv, int T, int S) {
  return B < 0 || T < 0 || S <= 0 || Hkv <= 0 || Hq < 0 || Hq % Hkv != 0 ||
         static_cast<long long>(B) * Hq >= (1LL << 31);
}

#define ATTN_WGMMA_BWD_CASES(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// The bfloat16 dQ: q, dO (B,Hq,T,d), k, v (B,Hkv,S,d) with element strides
// st = (q: b, h, t; k: b, h, t; v: b, h, t; dO: b, h, t), each last axis
// contiguous, base addresses and strides 16-byte aligned (the wrapper
// checks); m, l, delta contiguous (B,Hq,T) float32; dq contiguous
// (B,Hq,T,d).  Returns a CUDA error code.
inline int launch_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* m, const float* l, const float* delta, void* dq, int B, int Hq,
                     int Hkv, int T, int S, int d, const long long* st, int causal, float scale,
                     cudaStream_t stream) {
  if (bad_args(B, Hq, Hkv, T, S)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || T == 0) return static_cast<int>(cudaSuccess);
  switch (d) {
#define ATTN_WGMMA_BWD_DQ(DD)                                                                \
  case DD:                                                                                   \
    return launch_dq_d<DD>(q, k, v, dout, m, l, delta, dq, B, Hq, Hkv, T, S, st, causal, scale, \
                           stream);
    ATTN_WGMMA_BWD_CASES(ATTN_WGMMA_BWD_DQ)
#undef ATTN_WGMMA_BWD_DQ
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bfloat16 dK/dV: arguments as launch_dq; dk, dv contiguous (B,Hkv,S,d),
// the g query heads of each kv head summed.  With T == 0 they are zeros.
inline int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* m, const float* l, const float* delta, void* dk, void* dv,
                      int B, int Hq, int Hkv, int T, int S, int d, const long long* st,
                      int causal, float scale, cudaStream_t stream) {
  if (bad_args(B, Hq, Hkv, T, S)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  switch (d) {
#define ATTN_WGMMA_BWD_DKV(DD)                                                               \
  case DD:                                                                                   \
    return launch_dkv_d<DD>(q, k, v, dout, m, l, delta, dk, dv, B, Hq, Hkv, T, S, st, causal, \
                            scale, stream);
    ATTN_WGMMA_BWD_CASES(ATTN_WGMMA_BWD_DKV)
#undef ATTN_WGMMA_BWD_DKV
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef ATTN_WGMMA_BWD_CASES

}  // namespace attn_wgmma_bwd

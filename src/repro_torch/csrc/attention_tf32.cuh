// Float32 attention forward on the tensor cores for Hopper (sm_90a): float32
// q, k, v, o, scores, statistics and accumulators, every product on the
// TF32 tensor cores as the three-term split that keeps float32 accuracy.
// The body of the float32 launches of flash_attention.cu
// (flash_attention_fwd_tf32) and of flash_attention_bwd.cu's forward with
// statistics (flash_attention_fwd_stats_tf32), for head dims d % 8 == 0,
// 8 <= d <= 960.  Other float32 head dims keep the CUDA-core body
// (attention_tile.cuh); bfloat16 runs on attention_wgmma.cuh.
//
// Replaces the TPU kernels
//   _fwd_kernel        src/repro/kernels/flash_attention.py:25     (pallas_call :89)
//   _fwd_stats_kernel  src/repro/kernels/flash_attention_bwd.py:27 (pallas_call :147)
// Same function: q (B,Hq,T,d) against k, v (B,Hkv,S,d); query head h reads
// kv head h / (Hq/Hkv); s = (q.k) * scale; causal mask kpos <= qpos
// (top-left aligned); float32 online softmax; the denominator clamped at
// 1e-30; with statistics, the running max m (natural-log units of s) and
// l = max(l, 1e-30) per query row, as the float32 dQ and dK/dV bodies of
// flash_attention_bwd.cu read them back.
//
// Bound.  4*d flops per visible (query, key) pair against q, k, v read once
// and o written once.  In float32 the operations run at the 3xTF32 rate, the
// card's dense TF32 peak over three (494 / 3 TFLOP/s on the H100 SXM):
//   attn-LM prefill (8,1,128,960):       0.254 GFLOP 0.0015 ms, 15.7 MB 0.0047 ms (bytes)
//   mixed forward (2,15,256,64) vs (2,5,256,64): 0.253 GFLOP 0.0015 ms, 5.2 MB 0.0016 ms (bytes)
// The CUDA-core body (two shared loads per fused multiply-add, 67 TFLOP/s at
// best) stays 50-70x above those bounds.  One-pass TF32 (10-bit mantissas)
// would move s by ~5e-4 at d = 960 and o past the 2e-5 float32 gate.
//
// 3xTF32.  Each float32 operand x is split in registers as hi = tf32(x)
// (round to nearest) and lo = x - hi (exact; the tensor core reads its top
// 19 bits), and a.b is formed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into one
// float32 accumulator, the small terms first (the dropped lo.lo term is
// ~2^-22 relative).  Both products
// take it: Q.K^T, and P.V with P split as well, since the gate covers o.
// The products are mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32: wgmma takes
// TF32 only K-major from shared memory, which would need V transposed and a
// second buffer for the lo halves; mma.sync takes both halves from registers.
//
// Design.
//  * One block of four warps per (b*Hq + h, 64-row query tile, column chunk
//    of o); each warp owns 16 query rows.  Query tiles are launched longest
//    first (blockIdx.y reversed), so the causal walk's last wave is its
//    shortest.
//  * d = 960.  No block holds full-d tiles of Q, K, V and O.  O is cut into
//    column chunks of DC = 64 (d <= 64) or 128 columns, one per block, held
//    in registers; the ceil(d / DC) <= 8 blocks of one query tile form a
//    thread-block cluster.  Each block streams Q.K^T over its own DC columns
//    of d in chunks of 64 (Q and K chunks in a 4-stage cp.async ring) into
//    a 16 x 64 partial score tile per warp held in registers; the partials
//    are summed across the cluster through distributed shared memory, in
//    rank order, so every block holds the same full scores bitwise, and
//    P.V reads only the block's chunk of each V tile.  The Q.K^T work is
//    done once (not once per chunk of o), and the grid fills the card at
//    T = 128: 8 x 2 x 8 blocks at (8,1,128,960).  Tiles and the split
//    depend on d alone, never on B, T or S.
//  * Loads.  cp.async of 16 bytes, prefetched three stages ahead, one barrier
//    per stage; rows past T or S are zero-filled (src-size 0), so a masked
//    key's V row is 0, never stale.  Rows are padded to 68 (Q, K) and DC + 4
//    (V) floats: a fragment read of 32-bit elements (lane = 4g + t reads row
//    g or 2t, column t or g) then hits 32 distinct banks.  16-byte copies
//    need 16-byte aligned rows: the wrapper checks the base addresses and
//    strides and raises, it never falls back.
//  * Accumulation.  The tensor cores add a product into the float32
//    accumulator with truncation, not round-to-nearest, so the error grows
//    with the number of products summed into one accumulator and leans one
//    way: at d = 960 (360 products per score into one accumulator) o left
//    the 2e-5 gate on the card.  Each 64-column chunk of Q.K^T (24 products)
//    therefore sums into a fresh accumulator that is added to the score in
//    float32 (rounded to nearest), as are the cluster's partial scores.
//  * C -> A layout for TF32.  The m16n8 accumulator holds (g, 2t), (g, 2t+1),
//    (g+8, 2t), (g+8, 2t+1); the m16n8k8 TF32 A fragment wants (g, t),
//    (g+8, t), (g, t+4), (g+8, t+4), which is not the bf16 match.  Instead of
//    quad shuffles or a trip through shared memory, P.V renumbers the keys of
//    each 8-key step: A's k-slot t is key 2t and k-slot t+4 is key 2t+1, and
//    the B fragment reads V rows 2t and 2t+1 for the same slots.  The sum
//    over keys does not care which slot a key sits in, so the score
//    registers are the A fragment as they stand.
//  * Masking in registers.  Keys past S and, causal, keys past the row get
//    p = 0 explicitly (not exp of a large negative: a row with nothing seen
//    yet has m = -1e30 too); a warp skips key tiles wholly above its rows;
//    the block's walk stops at the tile holding its last query row; rows
//    past T are not stored.  A row with no visible key gives 0 / 1e-30 = 0,
//    m = -1e30 and l = 1e-30, as the CUDA-core body does.
//  * Softmax in exp2: scores are scaled by scale*log2(e) in registers, the
//    running max kept in those units, written as m = max * ln 2.  Row max and
//    sum are reduced across each quad by xor shuffles in fixed order.
//  * Determinism.  Fixed key order, fixed reduction order, no atomics:
//    row b of a batched launch is bitwise equal to a solo launch of row b,
//    and strided views equal contiguous inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace attn_tf32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;       // query rows per block
constexpr int kKeys = 64;                // keys per tile
constexpr int kChunk = 64;               // columns of d per Q.K^T stage
constexpr int kLdQK = kChunk + 4;        // padded row of a Q or K chunk (floats)
constexpr int kStages = 4;               // Q.K^T ring
constexpr int kAhead = kStages - 1;      // units in flight ahead of the one consumed
constexpr int kMaxD = 960;
constexpr float kNegInf = -1e30f;        // the TPU kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a block with O column chunks of DC (floats): the Q.K^T
// ring (a Q chunk and a K chunk per stage), two V tiles and, when d is split
// across a cluster, the block's partial scores.
template <int DC>
struct Smem {
  static constexpr int kLdV = DC + 4;
  static constexpr int kStage = (kRows + kKeys) * kLdQK;
  static constexpr int kVTile = kKeys * kLdV;
  static constexpr size_t kBytes = (kStages * kStage + 2 * kVTile) * sizeof(float);
  // a split block's partial scores: 32 per thread
  static constexpr size_t kSplitBytes = kThreads * (kKeys / 2) * sizeof(float);
};

// (b, h, t) element strides of q, k and v.
struct Strides {
  long long s[9];
};

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::mma;
using tf32::smem_u32;
using tf32::split;

// Wait until at most kAhead - 1 committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// c[n] += a.b[n] for 8 n-tiles in 3xTF32: b[n] holds the B fragment (k-slots
// t and t+4) of n-tile n.  The two cross terms first, then hi.hi, each as a
// pass over the 8 n-tiles, so that consecutive mma instructions are
// independent.
__device__ __forceinline__ void mma3x8(float (*c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const float (&b)[8][2]) {
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    split(b[n][0], bh[n][0], bl[n][0]);
    split(b[n][1], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) mma(c[n], ah, bh[n][0], bh[n][1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy rows [0, n) and columns [0, w) of a tile, row r at src + r*stride,
// into dst[r][ld] for r < cap and columns < W; the rest of the (cap, W) box
// is zero-filled, so the products may run over the whole box.  w is a
// multiple of 4.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long stride, int n, int cap, int w) {
  constexpr int kPieces = W / 4;
  for (int e = threadIdx.x; e < cap * kPieces; e += kThreads) {
    const int r = e / kPieces;
    const int c = (e - r * kPieces) * 4;
    const bool ok = r < n && c < w;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

// Cluster barrier halves and distributed shared memory: the Q.K^T split.
using hopper::cluster_arrive;
using hopper::cluster_rank;
using hopper::cluster_wait;
using hopper::ld_cluster;
using hopper::map_rank;

// One block: 64 query rows of one (b, h) against all its visible keys, o's
// columns [c0, c0 + DC) with c0 = DC * blockIdx.z.  The gridDim.z blocks of
// one query tile form a cluster; each sums Q.K^T over its own DC columns of
// d, and the partial scores are summed across the cluster in rank order
// (distributed shared memory), so every block holds the same full scores.
// m_out / l_out null: no statistics.  scale2 = scale * log2(e).
template <int DC>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out, int Hq,
    int group, int T, int S, int d, Strides st, int causal, float scale2) {
  using Sm = Smem<DC>;
  constexpr int NT = DC / 8;             // n-tiles of the o chunk
  constexpr int NS = kKeys / 8;          // n-tiles of the score tile
  static_assert(NS == 8 && NT % 8 == 0, "products run in groups of 8 n-tiles");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* vbuf = smem + kStages * Sm::kStage;
  float* xs = vbuf + 2 * Sm::kVTile;     // this block's partial scores (split only)

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;     // longest walks first
  const int nrows = T - q0 < kRows ? T - q0 : kRows;
  const int nsplit = gridDim.z;          // blocks (column chunks) of the cluster
  const int c0 = blockIdx.z * DC;
  const int ncols = d - c0 < DC ? d - c0 : DC;              // a multiple of 8
  const int nct = ncols >> 3;            // n-tiles of this chunk of o
  const int nkeys = causal && q0 + nrows < S ? q0 + nrows : S;
  const float* qb = q + b * st.s[0] + h * st.s[1] + q0 * st.s[2] + c0;
  const float* kb = k + b * st.s[3] + kvh * st.s[4] + c0;
  const float* vb = v + b * st.s[6] + kvh * st.s[7] + c0;
  const long long qst = st.s[2], kst = st.s[5], vst = st.s[8];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16;
  const int row0 = q0 + wrow + g;        // this thread's rows: row0 and row0 + 8

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float s[NS][4];
  float mx[2] = {kNegInf, kNegInf};      // running max of s * log2(e)
  float sum[2] = {0.0f, 0.0f};

  const int nchunks = (ncols + kChunk - 1) / kChunk;        // Q.K^T stages per key tile
  const int per_tile = nchunks + 1;                         // ... then the V tile
  const int units = (nkeys + kKeys - 1) / kKeys * per_tile;

  // Start the loads of unit u: Q.K^T stage (j, r < nchunks) or V tile j.
  auto issue = [&](int u) {
    const int j = u / per_tile;
    const int r = u - j * per_tile;
    const int j0 = j * kKeys;
    const int nk = nkeys - j0 < kKeys ? nkeys - j0 : kKeys;
    if (r < nchunks) {
      float* buf = ring + ((j * nchunks + r) % kStages) * Sm::kStage;
      const int col = r * kChunk;
      const int w = ncols - col < kChunk ? ncols - col : kChunk;
      load_tile<kChunk>(buf, kLdQK, qb + col, qst, nrows, kRows, w);
      load_tile<kChunk>(buf + kRows * kLdQK, kLdQK, kb + j0 * kst + col, kst, nk, kKeys, w);
    } else {
      load_tile<DC>(vbuf + (j & 1) * Sm::kVTile, Sm::kLdV, vb + j0 * vst, vst, nk, kKeys,
                    ncols);
    }
  };

  for (int u = 0; u < kAhead; ++u) {
    if (u < units) issue(u);
    cp_async_commit();                   // one group per unit, empty past the end
  }

  for (int u = 0; u < units; ++u) {
    cp_async_wait_ahead();               // unit u has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; unit u-1 is consumed
    // unit u + kAhead's buffer was last read by unit u-1 or older: kStages
    // Q.K^T stages, and two V tiles at least 2 * (nchunks + 1) units apart
    if (u + kAhead < units) issue(u + kAhead);
    cp_async_commit();

    const int j = u / per_tile;
    const int r = u - j * per_tile;
    const int j0 = j * kKeys;
    // causal: a tile wholly above this warp's rows changes nothing for it
    const bool live = !causal || j0 <= q0 + wrow + 15;

    if (r < nchunks) {
      // S (16 x 64 per warp) += Q chunk . K chunk^T
      if (r == 0) {
#pragma unroll
        for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      }
      if (live) {
        const float* sq = ring + ((j * nchunks + r) % kStages) * Sm::kStage;
        const float* sk = sq + kRows * kLdQK;
        // the chunk's products sum into a fresh accumulator, added to s in
        // float32 (see "Accumulation" above); a short last chunk is
        // zero-filled, so every k-step runs
        float part[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kChunk / 8; ++ks) {
          const float* qa = sq + (wrow + g) * kLdQK + ks * 8 + t;
          uint32_t ah[4], al[4];
          split(qa[0], ah[0], al[0]);
          split(qa[8 * kLdQK], ah[1], al[1]);
          split(qa[4], ah[2], al[2]);
          split(qa[8 * kLdQK + 4], ah[3], al[3]);
          float b[8][2];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float* kr = sk + (n * 8 + g) * kLdQK + ks * 8 + t;
            b[n][0] = kr[0];
            b[n][1] = kr[4];
          }
          mma3x8(part, ah, al, b);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
        }
      }
      if (r < nchunks - 1) continue;

      if (nsplit > 1) {
        // the cluster's partial scores, summed in rank order; every thread
        // of every block takes part in the barriers
        if (j > 0) cluster_wait();       // the previous tile's remote reads are done
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) xs[(n * 4 + e) * kThreads + tid] = s[n][e];
        }
        cluster_arrive();
        cluster_wait();                  // every block's partial is written
        if (live) {
          const uint32_t mine = smem_u32(xs + tid);
          for (int rank = 0; rank < nsplit; ++rank) {
            const uint32_t at = map_rank(mine, rank);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float x = ld_cluster(at + (n * 4 + e) * kThreads * 4);
                s[n][e] = rank == 0 ? x : s[n][e] + x;
              }
            }
          }
        }
        cluster_arrive();                // this block's reads are done
      }
      if (!live) continue;

      // scale, mask, online softmax; s becomes p
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        float tmax = kNegInf;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = j0 + n * 8 + 2 * t + e;
            const bool ok = key < S && (!causal || key <= row);
            const float x = ok ? s[n][2 * i + e] * scale2 : kNegInf;
            s[n][2 * i + e] = x;
            tmax = fmaxf(tmax, x);
          }
        }
        const float m_new = fmaxf(mx[i], quad_max(tmax));
        const float alpha = ex2(mx[i] - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = j0 + n * 8 + 2 * t + e;
            const bool ok = key < S && (!causal || key <= row);
            const float p = ok ? ex2(s[n][2 * i + e] - m_new) : 0.0f;
            s[n][2 * i + e] = p;
            psum += p;
          }
        }
        sum[i] = sum[i] * alpha + quad_sum(psum);
        mx[i] = m_new;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
    } else if (live) {
      // O chunk += P . V chunk; k-slot t is key 2t, k-slot t+4 key 2t+1
      const float* sv = vbuf + (j & 1) * Sm::kVTile;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[kk][0], ph[0], pl[0]);   // (g,   key 2t)
        split(s[kk][2], ph[1], pl[1]);   // (g+8, key 2t)
        split(s[kk][1], ph[2], pl[2]);   // (g,   key 2t+1)
        split(s[kk][3], ph[3], pl[3]);   // (g+8, key 2t+1)
        const float* vr = sv + (kk * 8 + 2 * t) * Sm::kLdV + g;
        // all NT n-tiles: the columns past this chunk are zero-filled and
        // their accumulators are never stored
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 8) {
          float b[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            b[n][0] = vr[(n0 + n) * 8];
            b[n][1] = vr[Sm::kLdV + (n0 + n) * 8];
          }
          mma3x8(acc + n0, ph, pl, b);
        }
      }
    }
  }
  // no block leaves while another may still read its partial scores
  if (nsplit > 1 && units > 0) cluster_wait();

  // epilogue: o = acc / max(l, 1e-30), rows past T not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    const float l = fmaxf(sum[i], 1e-30f);
    float* orow = o + (static_cast<long long>(bh) * T + row) * d + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nct) {
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
      }
    }
    if (m_out != nullptr && blockIdx.z == 0 && t == 0) {
      const long long at = static_cast<long long>(bh) * T + row;
      m_out[at] = mx[i] == kNegInf ? kNegInf : mx[i] * kLn2;   // natural-log units of s
      l_out[at] = l;
    }
  }
}

template <int DC>
inline int launch_dc(const float* q, const float* k, const float* v, float* o, float* m,
                     float* l, int B, int Hq, int Hkv, int T, int S, int d, const Strides& st,
                     int causal, float scale, cudaStream_t stream) {
  const int nsplit = (d + DC - 1) / DC;
  const size_t smem = Smem<DC>::kBytes + (nsplit > 1 ? Smem<DC>::kSplitBytes : 0);
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hq, (T + kRows - 1) / kRows, nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // the split's blocks: one cluster
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fwd_kernel<DC>, q, k, v, o, m, l, Hq, Hq / Hkv, T, S, d, st,
                           causal, scale * kLog2e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The float32 forward: q (B,Hq,T,d), k, v (B,Hkv,S,d) with element strides
// st = (q: b, h, t; k: b, h, t; v: b, h, t), each last axis contiguous,
// base addresses and strides 16-byte aligned (the wrapper checks); d % 8 ==
// 0, 8 <= d <= 960; o contiguous (B,Hq,T,d); m, l contiguous (B,Hq,T), or
// null for the forward without statistics.  Returns a CUDA error code.
inline int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l,
                  int B, int Hq, int Hkv, int T, int S, int d, const long long* strides,
                  int causal, float scale, cudaStream_t stream) {
  if (B < 0 || T < 0 || S < 0 || Hkv <= 0 || Hq % Hkv != 0 || d < 8 || d > kMaxD ||
      d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Hq == 0 || T == 0) return static_cast<int>(cudaSuccess);
  if (static_cast<long long>(B) * Hq >= (1LL << 31) || (T + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st;
  for (int i = 0; i < 9; ++i) st.s[i] = strides[i];
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (d <= 64) return launch_dc<64>(qf, kf, vf, of, m, l, B, Hq, Hkv, T, S, d, st, causal,
                                    scale, stream);
  return launch_dc<128>(qf, kf, vf, of, m, l, B, Hq, Hkv, T, S, d, st, causal, scale,
                        stream);
}

}  // namespace attn_tf32

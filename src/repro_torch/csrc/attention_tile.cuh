// CUDA-core body of the dense attention kernels: one thread block attends a
// tile of query rows to a run of key/value rows with a float32 online
// softmax, walking the keys in tiles of fixed order.  Its callers: the
// flash-decode kernel (decode_attention.cu, every launch), and the launches
// of flash_attention.cu and of flash_attention_bwd.cu's forward with
// statistics that neither tensor-core body takes: bfloat16 at d % 16 != 0
// or d > 256 (e.g. d = 960), float32 at d % 8 != 0 or d > 960.  bfloat16
// at d % 16 == 0, d <= 256 runs on attention_wgmma.cuh, float32 at d % 8 ==
// 0, d <= 960 on attention_tf32.cuh.
//
// Both TPU kernels it replaces keep (m, l, acc) in VMEM scratch across a
// sequential grid axis over the keys.  On Hopper, blocks run in parallel and
// in no order, so the key walk is a loop inside the block and the running
// state lives in shared memory.  Nothing is split across blocks and there
// are no atomics: a query row's result depends only on its own row and the
// keys it attends, in a fixed order, so it does not depend on batch-mates.
//
// Shared memory (floats), with ld = d + 1 so that threads reading one
// column of consecutive K rows hit distinct banks:
//   sq[bq][ld]   query rows          acc[bq][d]  unnormalised output
//   sk[bk][ld]   key tile            sv[bk][ld]  value tile
//   sp[bq][bk]   scores, then probabilities
//   sm, sl, sa [bq]  running max, denominator, this tile's rescale
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace attn {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;                         // tile loads in flight per thread
constexpr float kNegInf = -1e30f;                 // the TPU kernels' NEG_INF
constexpr size_t kMaxSmem = 227 * 1024;           // per block on the H100

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

inline size_t smem_bytes(int bq, int bk, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  const size_t floats = bq * ld + static_cast<size_t>(bq) * d + 2 * bk * ld +
                        static_cast<size_t>(bq) * bk + 3 * static_cast<size_t>(bq);
  return floats * sizeof(float);
}

// The largest (query rows, key rows) tile, in order of preference, whose
// shared memory fits one block; query rows are capped at `max_rows`.
// Depends on d and max_rows only, never on the batch.  Returns false if
// not even the smallest tile fits.
inline bool pick_tile(int d, int max_rows, int* bq, int* bk) {
  static const int kTiles[][2] = {{64, 64}, {32, 64}, {32, 32}, {16, 32}, {16, 16},
                                  {8, 16},  {8, 8},   {4, 8},   {2, 8},   {1, 8}};
  for (const auto& t : kTiles) {
    const int q = t[0] < max_rows ? t[0] : (max_rows > 0 ? max_rows : 1);
    if (smem_bytes(q, t[1], d) <= kMaxSmem) {
      *bq = q;
      *bk = t[1];
      return true;
    }
  }
  return false;
}

// Raise a kernel's dynamic shared memory limit (above 48 KB it is opt-in).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Attend `nrows` query rows (row r at q + r*q_stride, d contiguous) to keys
// j in [0, nkeys) (row j at k + j*k_stride and v + j*v_stride).  Row r sees
// key j iff j <= limit0 + r*limit_step.  Output row r goes to
// o + r*o_stride.  A row with nothing visible gives exact zeros when
// `zero_empty`, else acc / max(l, 1e-30) (the flash kernel's clamp; acc is
// zero there too).  When `m_out` is given, row r's running max goes to
// m_out[r] and its clamped denominator max(l, 1e-30) to l_out[r]: the
// statistics the backward kernels recompute the probabilities from.  When
// `lse_out` is given, row r's log-sum-exp of its scaled visible scores,
// m + ln(l), goes to lse_out[r], and -inf for a row with nothing visible:
// the statistic that folds this call with a call over other keys.
template <typename TQ, typename TKV, typename TO>
__device__ void attend_rows(const TQ* __restrict__ q, long long q_stride, int nrows,
                            const TKV* __restrict__ k, long long k_stride,
                            const TKV* __restrict__ v, long long v_stride, int nkeys,
                            int limit0, int limit_step, TO* __restrict__ o,
                            long long o_stride, int d, int bq, int bk, float scale,
                            bool zero_empty, float* smem,
                            float* __restrict__ m_out = nullptr,
                            float* __restrict__ l_out = nullptr,
                            float* __restrict__ lse_out = nullptr) {
  const int ld = d + 1;
  float* sq = smem;
  float* acc = sq + bq * ld;
  float* sk = acc + bq * d;
  float* sv = sk + bk * ld;
  float* sp = sv + bk * ld;
  float* sm = sp + bq * bk;
  float* sl = sm + bq;
  float* sa = sl + bq;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int e = tid; e < bq * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    sq[r * ld + c] = r < nrows ? to_f32(q[r * q_stride + c]) : 0.0f;
    acc[e] = 0.0f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.0f;
  }
  __syncthreads();

  for (int j0 = 0; j0 < nkeys; j0 += bk) {
    const int nk = nkeys - j0 < bk ? nkeys - j0 : bk;
    // kLoads independent loads in flight per thread before their stores:
    // one load-then-store per iteration would wait out the device memory
    // latency once per element
    for (int e0 = 0; e0 < bk * d; e0 += kLoads * kThreads) {
      float kx[kLoads], vx[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads + tid;
        const int j = e / d;
        const int c = e - j * d;
        kx[u] = 0.0f;
        vx[u] = 0.0f;
        if (e < bk * d && j < nk) {
          kx[u] = to_f32(k[(j0 + j) * k_stride + c]);
          vx[u] = to_f32(v[(j0 + j) * v_stride + c]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads + tid;
        const int j = e / d;
        if (e < bk * d) {
          sk[j * ld + e - j * d] = kx[u];
          sv[j * ld + e - j * d] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores: consecutive threads take consecutive keys of one query row
    for (int e = tid; e < bq * bk; e += kThreads) {
      const int r = e / bk;
      const int j = e - r * bk;
      const float* qr = sq + r * ld;
      const float* kr = sk + j * ld;
      float dot = 0.0f;
      for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
      const bool ok = j < nk && r < nrows && j0 + j <= limit0 + r * limit_step;
      sp[e] = ok ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row, lanes over the tile's keys
    for (int r = warp; r < bq; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, sp[r * bk + j]);
      mx = warp_max(mx);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        const bool ok = j < nk && r < nrows && j0 + j <= limit0 + r * limit_step;
        const float p = ok ? expf(sp[r * bk + j] - m_new) : 0.0f;
        sp[r * bk + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: consecutive threads take consecutive columns
    for (int e = tid; e < bq * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const float* pr = sp + r * bk;
      float pv = 0.0f;
      for (int j = 0; j < nk; ++j) pv = fmaf(pr[j], sv[j * ld + c], pv);
      acc[e] = acc[e] * sa[r] + pv;
    }
    // the next tile overwrites sk/sv/sp only after this barrier
    __syncthreads();
  }

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    const float l = sl[r];
    float out;
    if (zero_empty) {
      out = l <= 0.0f ? 0.0f : acc[e] / l;
    } else {
      out = acc[e] / fmaxf(l, 1e-30f);
    }
    o[r * o_stride + c] = from_f32<TO>(out);
  }
  if (m_out != nullptr) {
    for (int r = tid; r < nrows; r += kThreads) {
      m_out[r] = sm[r];
      l_out[r] = fmaxf(sl[r], 1e-30f);
    }
  }
  if (lse_out != nullptr) {
    for (int r = tid; r < nrows; r += kThreads) {
      lse_out[r] = sl[r] > 0.0f ? sm[r] + logf(sl[r]) : -CUDART_INF_F;
    }
  }
}

}  // namespace attn

// Flash attention for training on Hopper (sm_90a): the forward pass that
// also writes the softmax statistics, and the two backward kernels.  Float32
// or bfloat16 in, float32 statistics, accumulators and products, outputs and
// gradients in the input's type.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention_bwd.py:
//   fwd_stats_kernel  <- _fwd_stats_kernel (pallas_call at :147)
//   dq_kernel         <- _dq_kernel        (pallas_call at :205)
//   dkv_kernel        <- _dkv_kernel       (pallas_call at :218)
// Same functions: q (B,Hq,T,d) against k, v (B,Hkv,S,d); query head h reads
// kv head h / (Hq/Hkv); causal mask kpos <= qpos (top-left aligned);
// s = (q.k) * scale; the forward writes o, the running max m and the clamped
// denominator l = max(l, 1e-30) per query row; the backward recomputes
// p = exp(s - m) / l on the visible pairs and, with delta = sum(dO * O) per
// row (computed by the wrapper),
//   dS = p * (dO.V^T - delta),  dQ = dS.K * scale,  dK = dS^T.Q * scale,
//   dV = p^T.dO.
//
// Two bodies for each.  bfloat16 at d % 16 == 0 runs on the tensor cores
// (wgmma products, tiles by TMA): the forward with statistics up to d = 256
// on attention_wgmma.cuh (flash_attention_fwd_stats_wgmma), dQ and dK/dV up
// to d = 128 on attention_wgmma_bwd.cuh (flash_attention_dq_wgmma,
// flash_attention_dkv_wgmma).  Float32 and other d run the CUDA-core bodies
// below (flash_attention_fwd_stats, flash_attention_dq, flash_attention_dkv),
// which compute in float32 from shared memory (two shared loads per fused
// multiply-add).  The wrapper picks the body by (dtype, d) alone.
//
// Design of the CUDA-core bodies.  The TPU kernels carry their accumulators
// in VMEM scratch across a sequential grid axis (kv innermost for dQ, q
// innermost for dK/dV).  Here that axis is a loop inside one block, in fixed
// order:
//   * fwd_stats: one block per (b*Hq + h, query tile), an online softmax
//     with the statistics written out (attention_tile.cuh);
//   * dq: one block per (b*Hq + h, query tile), walking the key tiles up to
//     the tile holding the block's last query position (tiles above the
//     diagonal hold p = 0 exactly and are skipped);
//   * dkv: one block per (b*Hkv + kv head, key tile), walking the g query
//     heads of its group and, for each, the query tiles from the one holding
//     the tile's first key position.  The TPU wrapper repeats k and v to Hq
//     heads and sums the g per-head dK/dV partials afterwards; this block
//     sums them in float32 as it goes and rounds once.
// Every output element is written once by one block: no atomics, and row b
// of a batched launch is bitwise equal to a solo launch of row b (tiles are
// picked from d alone).  q, k, v and dO are read through their strides (last
// axis contiguous), so the model's (B,T,H,d) projections need no copy.  T
// and S need not be multiples of the tiles: a short last tile is masked.
//
// Bound.  The work is 2*d flops per product per (query, visible key) pair:
// two products in the forward, three in dq (q.k, dO.v, dS.k), four in dkv
// (q.k, dO.v, p^T.dO, dS^T.q), against reading the inputs once; at the
// training shapes the bf16 tensor-core rate bounds it, which the CUDA-core
// bodies stay ~190x away from (PERF.md).

#include "attention_tile.cuh"
#include "attention_wgmma.cuh"
#include "attention_wgmma_bwd.cuh"

namespace {

using attn::from_f32;
using attn::kLoads;
using attn::kMaxSmem;
using attn::kThreads;
using attn::to_f32;

// Copy `n` rows (row r at src + r*stride, d contiguous values) into
// dst[r][ld] as float32, zero-filling rows n..cap-1.  kLoads independent
// loads in flight per thread before their stores.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long stride,
                                          int n, int cap, int d, float* __restrict__ dst,
                                          int ld) {
  const int tid = threadIdx.x;
  const int total = cap * d;
  for (int e0 = 0; e0 < total; e0 += kLoads * kThreads) {
    float x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads + tid;
      const int r = e / d;
      const int c = e - r * d;
      x[u] = (e < total && r < n) ? to_f32(src[r * stride + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * kThreads + tid;
      const int r = e / d;
      if (e < total) dst[r * ld + e - r * d] = x[u];
    }
  }
}

// ---------------------------------------------------------------------------
// forward with statistics
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) fwd_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ m, float* __restrict__ l, int Hq, int Hkv,
    int T_len, int S, int d, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst, int causal,
    float scale, int bq, int bk) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.y * bq;
  const int nrows = T_len - q0 < bq ? T_len - q0 : bq;
  int nkeys = S;
  if (causal && q0 + nrows < S) nkeys = q0 + nrows;
  const long long row0 = static_cast<long long>(bh) * T_len + q0;
  attn::attend_rows<T, T, T>(
      q + b * qsb + h * qsh + q0 * qst, qst, nrows, k + b * ksb + kvh * ksh, kst,
      v + b * vsb + kvh * vsh, vst, nkeys, causal ? q0 : S, causal ? 1 : 0,
      o + row0 * d, d, d, bq, bk, scale, /*zero_empty=*/false, smem, m + row0, l + row0);
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*Hq + h, query tile), key tiles innermost
// ---------------------------------------------------------------------------

// sq, sdo [bq][ld]; sk, sv [bk][ld]; sds [bq][bk]; acc [bq][d]; sm, sl, sdl [bq]
inline size_t dq_smem_bytes(int bq, int bk, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  const size_t floats = 2 * bq * ld + 2 * bk * ld + static_cast<size_t>(bq) * bk +
                        static_cast<size_t>(bq) * d + 3 * static_cast<size_t>(bq);
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv, int T_len, int S,
    int d, long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst, long long dsb,
    long long dsh, long long dst, int causal, float scale, int bq, int bk) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sq = smem;
  float* sdo = sq + bq * ld;
  float* sk = sdo + bq * ld;
  float* sv = sk + bk * ld;
  float* sds = sv + bk * ld;
  float* acc = sds + bq * bk;
  float* sm = acc + bq * d;
  float* sl = sm + bq;
  float* sdl = sl + bq;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.y * bq;
  const int nrows = T_len - q0 < bq ? T_len - q0 : bq;
  const long long row0 = static_cast<long long>(bh) * T_len + q0;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  load_rows(q + b * qsb + h * qsh + q0 * qst, qst, nrows, bq, d, sq, ld);
  load_rows(dout + b * dsb + h * dsh + q0 * dst, dst, nrows, bq, d, sdo, ld);
  for (int e = tid; e < bq * d; e += kThreads) acc[e] = 0.0f;
  for (int r = tid; r < bq; r += kThreads) {
    const bool ok = r < nrows;
    sm[r] = ok ? m[row0 + r] : 0.0f;
    sl[r] = ok ? l[row0 + r] : 1.0f;
    sdl[r] = ok ? delta[row0 + r] : 0.0f;
  }

  // causal: the block's last query position q0 + nrows - 1 sees keys up to it
  int nkeys = S;
  if (causal && q0 + nrows < S) nkeys = q0 + nrows;
  for (int j0 = 0; j0 < nkeys; j0 += bk) {
    const int nk = nkeys - j0 < bk ? nkeys - j0 : bk;
    // the previous tile's readers of sk/sds finished at the loop's last barrier
    load_rows(kb + j0 * kst, kst, nk, bk, d, sk, ld);
    load_rows(vb + j0 * vst, vst, nk, bk, d, sv, ld);
    __syncthreads();

    // dS on the visible pairs: consecutive threads take consecutive keys of a row
    for (int e = tid; e < bq * bk; e += kThreads) {
      const int r = e / bk;
      const int j = e - r * bk;
      float ds = 0.0f;
      if (j < nk && r < nrows && (!causal || j0 + j <= q0 + r)) {
        const float* qr = sq + r * ld;
        const float* dr = sdo + r * ld;
        const float* kr = sk + j * ld;
        const float* vr = sv + j * ld;
        float qk = 0.0f, dv = 0.0f;
        for (int c = 0; c < d; ++c) {
          qk = fmaf(qr[c], kr[c], qk);
          dv = fmaf(dr[c], vr[c], dv);
        }
        // s rounded as the forward rounds it (no fused multiply-subtract)
        const float p = expf(__fmul_rn(qk, scale) - sm[r]) / sl[r];
        ds = p * (dv - sdl[r]);
      }
      sds[e] = ds;
    }
    __syncthreads();

    // dQ += dS K * scale: consecutive threads take consecutive columns
    for (int e = tid; e < bq * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const float* dr = sds + r * bk;
      float sum = 0.0f;
      for (int j = 0; j < nk; ++j) sum = fmaf(dr[j], sk[j * ld + c], sum);
      acc[e] += sum * scale;
    }
    __syncthreads();
  }

  for (int e = tid; e < nrows * d; e += kThreads) dq[row0 * d + e] = from_f32<T>(acc[e]);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (b*Hkv + kv head, key tile), query heads and tiles
// innermost
// ---------------------------------------------------------------------------

// sk, sv [bk][ld]; sq, sdo [bq][ld]; sp, sds [bq][bk]; dk, dv [bk][d];
// sm, sl, sdl [bq]
inline size_t dkv_smem_bytes(int bq, int bk, int d) {
  const size_t ld = static_cast<size_t>(d) + 1;
  const size_t floats = 2 * bk * ld + 2 * bq * ld + 2 * static_cast<size_t>(bq) * bk +
                        2 * static_cast<size_t>(bk) * d + 3 * static_cast<size_t>(bq);
  return floats * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Hq,
    int Hkv, int T_len, int S, int d, long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, long long dsb, long long dsh, long long dst, int causal, float scale,
    int bq, int bk) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* sk = smem;
  float* sv = sk + bk * ld;
  float* sq = sv + bk * ld;
  float* sdo = sq + bq * ld;
  float* sp = sdo + bq * ld;
  float* sds = sp + bq * bk;
  float* dk_acc = sds + bq * bk;
  float* dv_acc = dk_acc + bk * d;
  float* sm = dv_acc + bk * d;
  float* sl = sm + bq;
  float* sdl = sl + bq;

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int kvh = bkv - b * Hkv;
  const int g = Hq / Hkv;
  const int k0 = blockIdx.y * bk;
  const int nk = S - k0 < bk ? S - k0 : bk;

  load_rows(k + b * ksb + kvh * ksh + k0 * kst, kst, nk, bk, d, sk, ld);
  load_rows(v + b * vsb + kvh * vsh + k0 * vst, vst, nk, bk, d, sv, ld);
  for (int e = tid; e < bk * d; e += kThreads) {
    dk_acc[e] = 0.0f;
    dv_acc[e] = 0.0f;
  }
  // causal: query rows before k0 see none of this tile's keys
  const int first_q = causal ? (k0 / bq) * bq : 0;

  for (int i = 0; i < g; ++i) {
    const int h = kvh * g + i;
    const int bh = b * Hq + h;
    for (int q0 = first_q; q0 < T_len; q0 += bq) {
      const int nrows = T_len - q0 < bq ? T_len - q0 : bq;
      const long long row0 = static_cast<long long>(bh) * T_len + q0;
      // the previous tile's readers of sq/sdo/sp/sds finished at its last barrier
      load_rows(q + b * qsb + h * qsh + q0 * qst, qst, nrows, bq, d, sq, ld);
      load_rows(dout + b * dsb + h * dsh + q0 * dst, dst, nrows, bq, d, sdo, ld);
      for (int r = tid; r < bq; r += kThreads) {
        const bool ok = r < nrows;
        sm[r] = ok ? m[row0 + r] : 0.0f;
        sl[r] = ok ? l[row0 + r] : 1.0f;
        sdl[r] = ok ? delta[row0 + r] : 0.0f;
      }
      __syncthreads();

      // p and dS on the visible pairs: consecutive threads take consecutive keys
      for (int e = tid; e < bq * bk; e += kThreads) {
        const int r = e / bk;
        const int j = e - r * bk;
        float p = 0.0f, ds = 0.0f;
        if (j < nk && r < nrows && (!causal || k0 + j <= q0 + r)) {
          const float* qr = sq + r * ld;
          const float* dr = sdo + r * ld;
          const float* kr = sk + j * ld;
          const float* vr = sv + j * ld;
          float qk = 0.0f, dov = 0.0f;
          for (int c = 0; c < d; ++c) {
            qk = fmaf(qr[c], kr[c], qk);
            dov = fmaf(dr[c], vr[c], dov);
          }
          p = expf(__fmul_rn(qk, scale) - sm[r]) / sl[r];
          ds = p * (dov - sdl[r]);
        }
        sp[e] = p;
        sds[e] = ds;
      }
      __syncthreads();

      // dV += p^T dO, dK += dS^T Q * scale: consecutive threads take
      // consecutive columns of one key row
      for (int e = tid; e < bk * d; e += kThreads) {
        const int j = e / d;
        const int c = e - j * d;
        float sv_ = 0.0f, sk_ = 0.0f;
        for (int r = 0; r < nrows; ++r) {
          sv_ = fmaf(sp[r * bk + j], sdo[r * ld + c], sv_);
          sk_ = fmaf(sds[r * bk + j], sq[r * ld + c], sk_);
        }
        dv_acc[e] += sv_;
        dk_acc[e] += sk_ * scale;
      }
      __syncthreads();
    }
  }

  const long long out0 = (static_cast<long long>(bkv) * S + k0) * d;
  for (int e = tid; e < nk * d; e += kThreads) {
    dk[out0 + e] = from_f32<T>(dk_acc[e]);
    dv[out0 + e] = from_f32<T>(dv_acc[e]);
  }
}

// The largest tile of `prefs` (query rows, key rows), in order, whose shared
// memory fits one block.  Depends on d alone, never on the batch.
template <typename SmemFn>
bool pick(const int (*prefs)[2], int n, int d, SmemFn smem, int* bq, int* bk) {
  for (int i = 0; i < n; ++i) {
    if (smem(prefs[i][0], prefs[i][1], d) <= kMaxSmem) {
      *bq = prefs[i][0];
      *bk = prefs[i][1];
      return true;
    }
  }
  return false;
}

constexpr int kDqTiles[][2] = {{64, 64}, {32, 64}, {32, 32}, {16, 32}, {16, 16},
                               {8, 16},  {8, 8}};
// dkv keeps K, V and both accumulators for its key tile: a smaller query tile
// leaves room for two blocks per SM at d = 64
constexpr int kDkvTiles[][2] = {{32, 64}, {16, 64}, {32, 32}, {16, 32}, {16, 16},
                                {8, 16},  {8, 8}};
constexpr int kNumTiles = 7;

bool bad_grid(long long x, long long y) { return x <= 0 || x >= (1LL << 31) || y > 65535; }

template <typename T>
int launch_fwd_stats(const void* q, const void* k, const void* v, void* o, float* m,
                     float* l, int B, int Hq, int Hkv, int T_len, int S, int d,
                     const long long* s, int causal, float scale, cudaStream_t stream) {
  int bq = 0, bk = 0;
  if (!attn::pick_tile(d, 64, &bq, &bk)) return static_cast<int>(cudaErrorInvalidValue);
  const int ny = (T_len + bq - 1) / bq;
  if (bad_grid(static_cast<long long>(B) * Hq, ny)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn::smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(fwd_stats_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_stats_kernel<T><<<dim3(B * Hq, ny), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, Hq, Hkv, T_len, S, d, s[0], s[1], s[2], s[3], s[4], s[5],
      s[6], s[7], s[8], causal, scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* m, const float* l, const float* delta, void* dq, int B, int Hq,
              int Hkv, int T_len, int S, int d, const long long* s, int causal, float scale,
              cudaStream_t stream) {
  int bq = 0, bk = 0;
  if (!pick(kDqTiles, kNumTiles, d, dq_smem_bytes, &bq, &bk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ny = (T_len + bq - 1) / bq;
  if (bad_grid(static_cast<long long>(B) * Hq, ny)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dq_smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(dq_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T><<<dim3(B * Hq, ny), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), m, l, delta, static_cast<T*>(dq), Hq, Hkv, T_len, S, d,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], causal,
      scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dk, void* dv,
               int B, int Hq, int Hkv, int T_len, int S, int d, const long long* s,
               int causal, float scale, cudaStream_t stream) {
  int bq = 0, bk = 0;
  if (!pick(kDkvTiles, kNumTiles, d, dkv_smem_bytes, &bq, &bk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ny = (S + bk - 1) / bk;
  if (bad_grid(static_cast<long long>(B) * Hkv, ny)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dkv_smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(dkv_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<T><<<dim3(B * Hkv, ny), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, T_len, S, d, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
      s[10], s[11], causal, scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int Hq, int Hkv, int T_len, int S, int d) {
  return B < 0 || T_len < 0 || d < 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0;
}

}  // namespace

// Element strides: `strides` holds (b, h, t) strides of q, then k, then v
// (and, for the backward entry points, of dO), each with a contiguous last
// axis.  o, dq: contiguous (B,Hq,T,d); m, l, delta: contiguous (B,Hq,T)
// float32; dk, dv: contiguous (B,Hkv,S,d).  dtype: 0 float32, 1 bfloat16
// (q, k, v, o, dO and the gradients alike).  The wrapper checks shapes,
// types, devices and strides; these return a CUDA error code.

extern "C" int flash_attention_fwd_stats(const void* q, const void* k, const void* v,
                                         void* o, void* m, void* l, int dtype, int B,
                                         int Hq, int Hkv, int T_len, int S, int d,
                                         const long long* strides, int causal,
                                         float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, T_len, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || T_len == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  if (dtype == attn::kF32) {
    return launch_fwd_stats<float>(q, k, v, o, mf, lf, B, Hq, Hkv, T_len, S, d, strides,
                                   causal, scale, st);
  }
  if (dtype == attn::kBF16) {
    return launch_fwd_stats<__nv_bfloat16>(q, k, v, o, mf, lf, B, Hq, Hkv, T_len, S, d,
                                           strides, causal, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* m, const void* l,
                                  const void* delta, void* dq, int dtype, int B, int Hq,
                                  int Hkv, int T_len, int S, int d,
                                  const long long* strides, int causal, float scale,
                                  void* stream) {
  if (bad_shape(B, Hq, Hkv, T_len, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || T_len == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  if (dtype == attn::kF32) {
    return launch_dq<float>(q, k, v, dout, mf, lf, df, dq, B, Hq, Hkv, T_len, S, d,
                            strides, causal, scale, st);
  }
  if (dtype == attn::kBF16) {
    return launch_dq<__nv_bfloat16>(q, k, v, dout, mf, lf, df, dq, B, Hq, Hkv, T_len, S,
                                    d, strides, causal, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* m, const void* l,
                                   const void* delta, void* dk, void* dv, int dtype, int B,
                                   int Hq, int Hkv, int T_len, int S, int d,
                                   const long long* strides, int causal, float scale,
                                   void* stream) {
  if (bad_shape(B, Hq, Hkv, T_len, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Hq == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  if (dtype == attn::kF32) {
    return launch_dkv<float>(q, k, v, dout, mf, lf, df, dk, dv, B, Hq, Hkv, T_len, S, d,
                             strides, causal, scale, st);
  }
  if (dtype == attn::kBF16) {
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, mf, lf, df, dk, dv, B, Hq, Hkv, T_len,
                                     S, d, strides, causal, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 forward with statistics on the tensor-core body
// (attention_wgmma.cuh): arguments as flash_attention_fwd_stats without the
// dtype; base addresses and strides 16-byte aligned (TMA; the wrapper checks).
extern "C" int flash_attention_fwd_stats_wgmma(const void* q, const void* k, const void* v,
                                               void* o, void* m, void* l, int B, int Hq,
                                               int Hkv, int T_len, int S, int d,
                                               const long long* strides, int causal,
                                               float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, T_len, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  return attn_wgmma::launch(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), B,
                            Hq, Hkv, T_len, S, d, strides, causal, scale,
                            static_cast<cudaStream_t>(stream));
}

// The bfloat16 dQ and dK/dV on the tensor-core bodies
// (attention_wgmma_bwd.cuh): arguments as flash_attention_dq and
// flash_attention_dkv without the dtype, d % 16 == 0 and 16 <= d <= 128;
// base addresses and strides of q, k, v and dO 16-byte aligned (TMA; the
// wrapper checks).
extern "C" int flash_attention_dq_wgmma(const void* q, const void* k, const void* v,
                                        const void* dout, const void* m, const void* l,
                                        const void* delta, void* dq, int B, int Hq, int Hkv,
                                        int T_len, int S, int d, const long long* strides,
                                        int causal, float scale, void* stream) {
  return attn_wgmma_bwd::launch_dq(q, k, v, dout, static_cast<const float*>(m),
                                   static_cast<const float*>(l),
                                   static_cast<const float*>(delta), dq, B, Hq, Hkv, T_len, S,
                                   d, strides, causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_dkv_wgmma(const void* q, const void* k, const void* v,
                                         const void* dout, const void* m, const void* l,
                                         const void* delta, void* dk, void* dv, int B, int Hq,
                                         int Hkv, int T_len, int S, int d,
                                         const long long* strides, int causal, float scale,
                                         void* stream) {
  return attn_wgmma_bwd::launch_dkv(q, k, v, dout, static_cast<const float*>(m),
                                    static_cast<const float*>(l),
                                    static_cast<const float*>(delta), dk, dv, B, Hq, Hkv, T_len,
                                    S, d, strides, causal, scale,
                                    static_cast<cudaStream_t>(stream));
}

// Dense flash-decode for Hopper (sm_90a): one query token per (b, q head)
// against a KV cache.  q in float32 or bfloat16, the cache in float32 or
// bfloat16 (independently), float32 statistics, output in q's type.
//
// Replaces the TPU kernel `decode_attention_kernel` -> `_decode_kernel` in
// src/repro/kernels/decode_attention.py (pallas_call at :93).  Same
// function: q (B,Hq,1,d) against k, v (B,Hkv,S,d); q head h reads kv head
// h / (Hq/Hkv); cache position kpos is visible iff kpos <= pos for the
// scalar pos; s = (q.k) * scale; a row with nothing visible (pos < 0) gives
// exact zeros.
//
// Design.  One block per (b, kv head, chunk of its group of q heads): the
// block walks the cache once for all `group` query rows that share the kv
// head, so each K/V row is read once per group, not once per q head.  pos is
// read from device memory (no host sync per step) and the walk stops at
// min(pos + 1, S), in fixed order (attention_tile.cuh).  The cache is read
// through its strides, so the model's (B,S,Hkv,d) cache is attended in
// place, seen as (B,Hkv,S,d), and a decode step copies no cache.
//
// Bound.  About 4*d flops per visible cache row and query row against
// 2*d elements of K/V read per cache row and kv head: memory-bound, the
// least time is the visible cache bytes over 3.35 TB/s.  This first kernel
// gives each (b, kv head) one block (40 blocks at SmolLM-360M's B=8, Hkv=5)
// and walks the cache in one sequence; splitting the cache over blocks
// with a fixed-order combine is the later speed change.

#include "attention_tile.cuh"

namespace {

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(attn::kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ pos, TQ* __restrict__ o, int Hq, int Hkv, int S, int d,
    long long qsb, long long qsh, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, float scale, int bq, int bk) {
  extern __shared__ float smem[];
  const int group = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int g0 = blockIdx.y * bq;
  const int nrows = group - g0 < bq ? group - g0 : bq;
  const int h0 = kvh * group + g0;
  const int p = __ldg(pos);
  const int nkeys = p < 0 ? 0 : (p < S - 1 ? p + 1 : S);
  attn::attend_rows<TQ, TKV, TQ>(
      q + b * qsb + h0 * qsh, qsh, nrows, k + b * ksb + kvh * ksh, kss,
      v + b * vsb + kvh * vsh, vss, nkeys, /*limit0=*/p, /*limit_step=*/0,
      o + (static_cast<long long>(b) * Hq + h0) * d, d, d, bq, bk, scale,
      /*zero_empty=*/true, smem);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* pos, void* o, int B,
           int Hq, int Hkv, int S, int d, long long qsb, long long qsh, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh, long long vss,
           float scale, cudaStream_t stream) {
  const int group = Hq / Hkv;
  int bq = 0, bk = 0;
  if (!attn::pick_tile(d, group, &bq, &bk)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn::smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(decode_attention_kernel<TQ, TKV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hkv, (group + bq - 1) / bq);
  decode_attention_kernel<TQ, TKV><<<grid, attn::kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(pos), static_cast<TQ*>(o), Hq, Hkv, S, d, qsb, qsh, ksb, ksh,
      kss, vsb, vsh, vss, scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v, const void* pos,
              void* o, int B, int Hq, int Hkv, int S, int d, long long qsb, long long qsh,
              long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
              long long vss, float scale, cudaStream_t stream) {
  if (kv_dtype == attn::kF32) {
    return launch<TQ, float>(q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb, ksh, kss,
                             vsb, vsh, vss, scale, stream);
  }
  if (kv_dtype == attn::kBF16) {
    return launch<TQ, __nv_bfloat16>(q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb,
                                     ksh, kss, vsb, vsh, vss, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B,Hq,1,d) with element strides (qsb, qsh, -, 1); k, v: (B,Hkv,S,d)
// with strides (ksb, ksh, kss, 1) and (vsb, vsh, vss, 1); pos: one int32 on
// the device; o: contiguous (B,Hq,1,d) in q's type.  Types: 0 float32,
// 1 bfloat16.  The wrapper checks shapes, types, devices and strides; this
// returns a CUDA error code.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, int q_dtype, int kv_dtype,
                                    int B, int Hq, int Hkv, int S, int d, long long qsb,
                                    long long qsh, long long ksb, long long ksh,
                                    long long kss, long long vsb, long long vsh,
                                    long long vss, float scale, void* stream) {
  if (B == 0 || Hq == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == attn::kF32) {
    return launch_kv<float>(kv_dtype, q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb,
                            ksh, kss, vsb, vsh, vss, scale, s);
  }
  if (q_dtype == attn::kBF16) {
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh,
                                    ksb, ksh, kss, vsb, vsh, vss, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

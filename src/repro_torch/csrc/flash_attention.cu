// Flash attention (forward) for Hopper (sm_90a), float32 or bfloat16 in,
// float32 statistics and accumulator, output in the input's type.
//
// Replaces the TPU kernel `flash_attention_kernel` -> `_fwd_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :89).  Same
// function: q (B,Hq,T,d) against k, v (B,Hkv,S,d); query head h reads kv
// head h / (Hq/Hkv) (GQA, never repeated in memory); causal mask
// kpos <= qpos (top-left aligned); s = (q.k) * scale; the denominator is
// clamped at 1e-30.
//
// Three routes, chosen by the wrapper from (dtype, d) alone:
//   * flash_attention_fwd_wgmma: bfloat16 with d % 16 == 0, d <= 256 (the
//     dense, hybrid and training prefills), on the tensor-core body of
//     attention_wgmma.cuh: wgmma products, TMA tiles, a producer warp.
//   * flash_attention_fwd_tf32: float32 with d % 8 == 0, 8 <= d <= 960 (the
//     attn LM's d = 960 prefill, the float32 mixed forward), on the
//     tensor-core body of attention_tf32.cuh: mma.sync products in 3xTF32,
//     cp.async tiles, o in column chunks of 64 or 128.
//   * flash_attention_fwd: float32 and bfloat16 at other d, on the
//     CUDA-core body of attention_tile.cuh: one block per (b*Hq + h, tile
//     of query rows), the TPU's sequential kv grid axis a loop over key
//     tiles inside the block, in fixed order, stopping at the tile holding
//     the block's last query position for a causal call.  Its tile depends
//     on d alone (K+V tiles fit 227 KB up to d = 960 and beyond).
// Either way row b of a batched launch is bitwise equal to a solo launch of
// row b, and q, k and v are read through their strides (last axis
// contiguous), so the model's (B,T,H,d) projections need no transposing copy.
//
// Bound.  At the prefill shapes the work is 4*d flops per (query, visible
// key) pair against reading q, k, v and writing o once: at the card's
// balance point in bf16 (see attention_wgmma.cuh for the numbers), and near
// it in float32 at the 3xTF32 rate (see attention_tf32.cuh).  The CUDA-core
// route computes in float32 from shared memory (two shared loads per fused
// multiply-add); one-pass TF32 would break the float32 calls' 2e-5 gate,
// which the three-term split keeps.

#include "attention_tile.cuh"
#include "attention_tf32.cuh"
#include "attention_wgmma.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(attn::kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int T_len, int S, int d, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, int causal, float scale, int bq,
    int bk) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.y * bq;
  const int nrows = T_len - q0 < bq ? T_len - q0 : bq;
  // causal: the block's last query position q0 + nrows - 1 sees keys up to it
  int nkeys = S;
  if (causal && q0 + nrows < S) nkeys = q0 + nrows;
  attn::attend_rows<T, T, T>(
      q + b * qsb + h * qsh + q0 * qst, qst, nrows, k + b * ksb + kvh * ksh, kst,
      v + b * vsb + kvh * vsh, vst, nkeys, causal ? q0 : S, causal ? 1 : 0,
      o + (static_cast<long long>(bh) * T_len + q0) * d, d, d, bq, bk, scale,
      /*zero_empty=*/false, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int T_len, int S, int d, long long qsb, long long qsh, long long qst,
           long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
           long long vst, int causal, float scale, cudaStream_t stream) {
  int bq = 0, bk = 0;
  if (!attn::pick_tile(d, 64, &bq, &bk)) return static_cast<int>(cudaErrorInvalidValue);
  if ((T_len + bq - 1) / bq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn::smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (T_len + bq - 1) / bq);
  flash_attention_kernel<T><<<grid, attn::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, T_len, S, d, qsb, qsh, qst, ksb, ksh, kst, vsb, vsh,
      vst, causal, scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B,Hq,T,d) with element strides (qsb, qsh, qst, 1); k, v: (B,Hkv,S,d)
// with strides (ksb, ksh, kst, 1) and (vsb, vsh, vst, 1); o: contiguous
// (B,Hq,T,d).
// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  The wrapper checks
// shapes, types, devices and strides; this returns a CUDA error code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Hq, int Hkv, int T_len, int S,
                                   int d, long long qsb, long long qsh, long long qst,
                                   long long ksb, long long ksh, long long kst,
                                   long long vsb, long long vsh, long long vst,
                                   int causal, float scale, void* stream) {
  if (B == 0 || Hq == 0 || T_len == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == attn::kF32) {
    return launch<float>(q, k, v, o, B, Hq, Hkv, T_len, S, d, qsb, qsh, qst, ksb, ksh,
                         kst, vsb, vsh, vst, causal, scale, s);
  }
  if (dtype == attn::kBF16) {
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, T_len, S, d, qsb, qsh, qst,
                                 ksb, ksh, kst, vsb, vsh, vst, causal, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 forward on the tensor-core body (attention_wgmma.cuh).
// strides: (b, h, t) element strides of q, then k, then v, each with a
// contiguous last axis; base addresses and strides 16-byte aligned (TMA;
// the wrapper checks).  o: contiguous (B,Hq,T,d) bfloat16.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         void* o, int B, int Hq, int Hkv, int T_len, int S,
                                         int d, const long long* strides, int causal,
                                         float scale, void* stream) {
  return attn_wgmma::launch(q, k, v, o, nullptr, nullptr, B, Hq, Hkv, T_len, S, d, strides,
                            causal, scale, static_cast<cudaStream_t>(stream));
}

// The float32 forward on the 3xTF32 tensor-core body (attention_tf32.cuh).
// strides: (b, h, t) element strides of q, then k, then v, each with a
// contiguous last axis; base addresses and strides 16-byte aligned
// (cp.async; the wrapper checks); d % 8 == 0, 8 <= d <= 960.  o: contiguous
// (B,Hq,T,d) float32.
extern "C" int flash_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                        void* o, int B, int Hq, int Hkv, int T_len, int S,
                                        int d, const long long* strides, int causal,
                                        float scale, void* stream) {
  return attn_tf32::launch(q, k, v, o, nullptr, nullptr, B, Hq, Hkv, T_len, S, d, strides,
                           causal, scale, static_cast<cudaStream_t>(stream));
}

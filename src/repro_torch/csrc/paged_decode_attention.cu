// Block-sparse paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel `paged_decode_attention_kernel` -> `_paged_kernel`
// in src/repro/kernels/decode_attention.py (pallas_call at :234).  Same
// function: stream b walks its block table tables[b, :] in logical order,
// visits page j only while j*ps < len[b], keeps an online softmax of
// q.k/sqrt(d) with a kpos < len mask on the tail page, and folds the
// optional fresh (kn, vn) row in last at logical position len[b].  Without
// a fresh row, a stream with len == 0 yields exact zeros.
//
// Design.  One thread block per stream; blocks share nothing, and the page
// walk inside a block is a loop in fixed logical order (the TPU kernel's
// sequential grid axis).  Per page: each warp takes rows r = warp, warp+8,
// ... and reduces q.k over d with shuffles into shared memory; then every
// thread derives the same running max and probabilities from shared memory
// and rescales the float32 accumulator entries it owns (acc[i] for
// i = tid, tid+256, ...).  No atomics, no cross-block reduction: a stream's
// output depends only on its own q row, table row and the pages they name,
// so row b of a batched launch is bitwise equal to a solo launch of row b,
// whatever physical page ids either used.
//
// Bound.  The work is ~4*d flops per live position against 8*d bytes of
// K/V read, so it is memory-bound: the least time is the live KV bytes
// (plus q, kn, vn, out) over the card's 3.35 TB/s.  This first kernel puts
// one block on each stream, so it fills only B of the H100's 132 SMs (8 at
// the serving shape) and walks a stream's pages one after another; splitting
// a stream's pages over several blocks, combined in a fixed order to keep
// the bitwise contract, is the later speed change.
//
// Contract (checked by the Python wrapper, not here): every tensor float32
// or int32 as named, contiguous, on one CUDA device; table entries that a
// stream visits are valid page ids in [0, P).  Dead slots are never read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ out, int d, int ps,
    int npages, int has_fresh, float scale) {
  extern __shared__ float smem[];
  const int nscore = ps > kWarps ? ps : kWarps;
  float* sq = smem;           // d: this stream's query row
  float* acc = sq + d;        // d: unnormalised output (thread-owned entries)
  float* score = acc + d;     // nscore: page scores, then warp partials
  float* prob = score + nscore;  // ps: the page's softmax numerators

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = lengths[b];
  const float* qb = q + static_cast<size_t>(b) * d;
  for (int i = tid; i < d; i += kThreads) {
    sq[i] = qb[i];
    acc[i] = 0.0f;
  }
  __syncthreads();

  // every thread carries the same running max and denominator: they are
  // computed from shared memory in the same order by all threads
  float m = kNegInf;
  float l = 0.0f;
  const int* table = tables + static_cast<size_t>(b) * npages;
  for (int j = 0; j < npages && j * ps < len; ++j) {
    const size_t base = static_cast<size_t>(table[j]) * ps * d;
    const float* kpage = k_pages + base;
    const float* vpage = v_pages + base;

    for (int r = warp; r < ps; r += kWarps) {
      const float* krow = kpage + static_cast<size_t>(r) * d;
      float dot = 0.0f;
      for (int i = lane; i < d; i += 32) dot += sq[i] * krow[i];
      dot = warp_sum(dot);
      if (lane == 0) score[r] = (j * ps + r < len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    float m_new = m;
    for (int r = 0; r < ps; ++r) m_new = fmaxf(m_new, score[r]);
    for (int r = tid; r < ps; r += kThreads) {
      prob[r] = (j * ps + r < len) ? expf(score[r] - m_new) : 0.0f;
    }
    const float alpha = expf(m - m_new);
    __syncthreads();

    float psum = 0.0f;
    for (int r = 0; r < ps; ++r) psum += prob[r];
    l = l * alpha + psum;
    for (int i = tid; i < d; i += kThreads) {
      float pv = 0.0f;
      for (int r = 0; r < ps; ++r) pv += prob[r] * vpage[static_cast<size_t>(r) * d + i];
      acc[i] = acc[i] * alpha + pv;
    }
    m = m_new;
    // the next page's scores overwrite `score` only after every thread has
    // passed the next __syncthreads, by which time all reads here are done
  }

  float* ob = out + static_cast<size_t>(b) * d;
  if (has_fresh) {
    // the fresh row at logical position len: attended last, so the softmax
    // always has a valid entry and the denominator is positive
    const float* knb = kn + static_cast<size_t>(b) * d;
    const float* vnb = vn + static_cast<size_t>(b) * d;
    float part = 0.0f;
    for (int i = tid; i < d; i += kThreads) part += sq[i] * knb[i];
    part = warp_sum(part);
    // every read of `score` by the page loop ended before its last barrier
    if (lane == 0) score[warp] = part;
    __syncthreads();
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += score[w];
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float p = expf(s - m_new);
    const float alpha = expf(m - m_new);
    const float l_new = l * alpha + p;
    for (int i = tid; i < d; i += kThreads) {
      ob[i] = (acc[i] * alpha + p * vnb[i]) / l_new;
    }
  } else {
    // a stream that visited nothing: exact zeros by contract
    for (int i = tid; i < d; i += kThreads) {
      ob[i] = l <= 0.0f ? 0.0f : acc[i] / l;
    }
  }
}

}  // namespace

extern "C" int paged_decode_attention_f32(
    const void* q, const void* kn, const void* vn, const void* k_pages,
    const void* v_pages, const void* tables, const void* lengths, void* out,
    int batch, int d, int ps, int npages, int has_fresh, float scale,
    void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const int nscore = ps > kWarps ? ps : kWarps;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(d) + nscore + ps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode_attention_kernel<<<batch, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), d, ps,
      npages, has_fresh, scale);
  return static_cast<int>(cudaGetLastError());
}

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
// Bound.  ~4*d flops per live position against 8*d bytes of K/V read
// (0.5 flops a byte), so it is memory-bound: the least time is the live KV
// bytes (plus q, kn, vn, out, lengths and the live table slots) over the
// card's 3.35 TB/s.  At the serving shape (B 8, d 960, ps 16, lengths
// 136..160 at the decode midpoint) that is 9.2 MB, 0.0027 ms.
//
// Two bodies, picked by the wrapper (paged_route):
//  * "split" (paged_decode_attention_split_f32), the path's body.  A
//    thread-block cluster of C blocks (C fixed by d and ps, never by B; up to
//    16, the non-portable cluster size) takes each stream; rank r takes the
//    contiguous run of live pages [r*n/C, (r+1)*n/C), n = ceil(len/ps).  A
//    page of K is one contiguous ps*d*4-byte run (61,440 B at ps 16, d 960):
//    one thread fetches it whole with a 1-D bulk copy (cp.async.bulk, TMA
//    without a tensor map) onto an mbarrier, K and V on separate barriers, so
//    the scores start while V is still landing and the next page's K lands
//    during this page's P.V.  Scores: a warp a key, 16-byte shared reads of
//    K against q; softmax: one warp; P.V: a thread per four columns, 16-byte
//    reads.  Each rank then stores its (m, l, acc[d]) into rank 0's shared
//    memory (distributed shared memory), and after one cluster barrier rank
//    0 folds the ranks in rank order, then the fresh row, and writes o.  A
//    rank with no pages contributes m = NEG_INF, l = 0.  Needs d % 4 == 0,
//    16-byte aligned pools and two pages in shared memory.
//  * "simt" (paged_decode_attention_f32), the CUDA-core body for every other
//    shape: one block per stream walks its pages one after another, reading
//    K and V straight from device memory.
// Both keep the contract: a stream's output depends only on its own q row,
// table row and the pages they name, summed in a fixed order with no
// atomics, so row b of a batched launch is bitwise equal to a solo launch of
// row b, whatever physical page ids either used, and two launches on the
// same input are bitwise equal.
//
// Measured (chip_smoke.py, two runs, NVIDIA H100 80GB HBM3 at 700.00 W,
// cold L2): the serving step 0.0187 ms at C = 8 against 0.2254-0.2257 on
// the simt body.  Like the dense split it is bound by latency: the length,
// the table entry and a page's bulk copy come one after another before the
// first score.
//
// Contract (checked by the Python wrapper, not here): every tensor float32
// or int32 as named, contiguous, on one CUDA device; table entries that a
// stream visits are valid page ids in [0, P).  Dead slots are never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

// ---------------------------------------------------------------------------
// "simt": one block per stream
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// "split": a stream's pages split over a thread-block cluster
// ---------------------------------------------------------------------------

namespace split {

constexpr int kMaxUnits = 2;       // float4 columns a thread owns: d <= 4 * 2 * kThreads
constexpr int kMaxSplit = 16;      // blocks per cluster (non-portable above 8)

// Shared memory (bytes) of a block at (d, ps) in a cluster of nsplit: the
// K and V pages, q, the page's scores, the statistics (m, l, alpha), the
// warps' partial sums of the fresh row's score, two mbarriers, and every
// rank's (acc[d], m, l), stored by the ranks into rank 0's copy.
struct Layout {
  size_t sk, sv, sq, sp, stat, red, bar, racc, rstat, bytes;
  __host__ __device__ Layout(int d, int ps, int nsplit) {
    const size_t page = static_cast<size_t>(ps) * d * 4;
    sk = 0;
    sv = page;
    sq = 2 * page;
    sp = sq + 4 * static_cast<size_t>(d);
    stat = sp + 4 * ((static_cast<size_t>(ps) + 3) / 4 * 4);
    red = stat + 16;
    bar = red + 4 * kWarps;
    racc = bar + 16;
    rstat = racc + 4 * static_cast<size_t>(nsplit) * d;
    bytes = rstat + 8 * static_cast<size_t>(nsplit);
  }
};

__device__ __forceinline__ void fma4(float4& a, float p, const float4& x) {
  a.x = fmaf(p, x.x, a.x);
  a.y = fmaf(p, x.y, a.y);
  a.z = fmaf(p, x.z, a.z);
  a.w = fmaf(p, x.w, a.w);
}

// Thread 0: fetch `bytes` of one page into shared memory, completing on bar.
__device__ __forceinline__ void fetch(unsigned char* dst, const float* src, uint32_t bytes,
                                      uint32_t bar) {
  hopper::mbar_expect_tx(bar, bytes);
  hopper::bulk_load(hopper::smem_u32(dst), src, bytes, bar);
}

__global__ void __launch_bounds__(kThreads) split_kernel(
    const float* __restrict__ q, const float* __restrict__ kn,
    const float* __restrict__ vn, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ out, int d, int ps,
    int npages, int has_fresh, float scale, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(d, ps, nsplit);
  unsigned char* sk = smem + lay.sk;
  unsigned char* sv = smem + lay.sv;
  const float* kf = reinterpret_cast<const float*>(sk);
  const float* vf = reinterpret_cast<const float*>(sv);
  float* sq = reinterpret_cast<float*>(smem + lay.sq);
  float* sp = reinterpret_cast<float*>(smem + lay.sp);
  float* stat = reinterpret_cast<float*>(smem + lay.stat);   // m, l, alpha
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const uint32_t bar_k = hopper::smem_u32(smem + lay.bar);
  const uint32_t bar_v = bar_k + 8;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int b = blockIdx.x / nsplit;
  const int len = lengths[b];
  // q first: its loads need neither the length nor the table
  const float* qb = q + static_cast<size_t>(b) * d;
  for (int i = tid; i < d; i += kThreads) sq[i] = qb[i];
  const int* table = tables + static_cast<size_t>(b) * npages;
  int live = len > 0 ? (len + ps - 1) / ps : 0;
  live = live < npages ? live : npages;
  const int p0 = rank * live / nsplit;
  const int p1 = (rank + 1) * live / nsplit;
  const uint32_t page_bytes = static_cast<uint32_t>(ps) * d * 4;
  const size_t page_elems = static_cast<size_t>(ps) * d;

  if (tid == 0) {
    hopper::mbar_init(bar_k, 1);
    hopper::mbar_init(bar_v, 1);
    hopper::mbar_fence_init();
    stat[0] = kNegInf;
    stat[1] = 0.0f;
  }
  __syncthreads();   // q, the statistics and the initialised barriers
  if (tid == 0 && p0 < p1) {
    const size_t base = static_cast<size_t>(table[p0]) * page_elems;
    fetch(sk, k_pages + base, page_bytes, bar_k);
    fetch(sv, v_pages + base, page_bytes, bar_v);
  }

  const int U = d / 4;
  float4 acc[kMaxUnits];
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int j = p0; j < p1; ++j) {
    const uint32_t parity = (j - p0) & 1;
    const int nk = len - j * ps < ps ? len - j * ps : ps;
    const size_t next = j + 1 < p1 ? static_cast<size_t>(table[j + 1]) * page_elems : 0;

    // scores: a warp a key, lanes over 16-byte pieces of the row
    hopper::mbar_wait(bar_k, parity);
    for (int r = warp; r < ps; r += kWarps) {
      const float4* kr = reinterpret_cast<const float4*>(kf + static_cast<size_t>(r) * d);
      const float4* qr = reinterpret_cast<const float4*>(sq);
      float dot = 0.0f;
      for (int u = lane; u < U; u += 32) {
        const float4 kx = kr[u];
        const float4 qx = qr[u];
        dot = fmaf(qx.x, kx.x, dot);
        dot = fmaf(qx.y, kx.y, dot);
        dot = fmaf(qx.z, kx.z, dot);
        dot = fmaf(qx.w, kx.w, dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) sp[r] = r < nk ? dot * scale : kNegInf;
    }
    __syncthreads();   // scores written, K read: the next page's K may land
    if (tid == 0 && j + 1 < p1) fetch(sk, k_pages + next, page_bytes, bar_k);

    // the page's online softmax, one warp
    if (warp == 0) {
      float mx = kNegInf;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, sp[r]);
      const float m_prev = stat[0];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.0f;
      for (int r = lane; r < ps; r += 32) {
        const float pr = r < nk ? expf(sp[r] - m_new) : 0.0f;
        sp[r] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        stat[2] = alpha;
        stat[1] = stat[1] * alpha + sum;
        stat[0] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V: a thread per 16-byte piece of the row
    hopper::mbar_wait(bar_v, parity);
    const float alpha = stat[2];
#pragma unroll
    for (int i = 0; i < kMaxUnits; ++i) {
      const int u = tid + i * kThreads;
      if (u < U) {
        float4 a = acc[i];
        a.x *= alpha;
        a.y *= alpha;
        a.z *= alpha;
        a.w *= alpha;
        for (int r = 0; r < nk; ++r) {
          fma4(a, sp[r], reinterpret_cast<const float4*>(vf + static_cast<size_t>(r) * d)[u]);
        }
        acc[i] = a;
      }
    }
    __syncthreads();   // V and the probabilities read: the next page's V may land
    if (tid == 0 && j + 1 < p1) fetch(sv, v_pages + next, page_bytes, bar_v);
  }

  // store this rank's (acc, m, l) into rank 0's recv; rank 0 also takes the
  // fresh row's score
  const uint32_t racc = hopper::map_rank(hopper::smem_u32(smem + lay.racc), 0) +
                        static_cast<uint32_t>(rank * d * 4);
#pragma unroll
  for (int i = 0; i < kMaxUnits; ++i) {
    const int u = tid + i * kThreads;
    if (u < U) hopper::st_cluster4(racc + 16 * u, acc[i]);
  }
  if (tid == 0) {
    const uint32_t rstat = hopper::map_rank(hopper::smem_u32(smem + lay.rstat), 0) +
                           static_cast<uint32_t>(rank * 8);
    hopper::st_cluster(rstat, stat[0]);
    hopper::st_cluster(rstat + 4, stat[1]);
  }
  if (rank == 0 && has_fresh) {
    const float* knb = kn + static_cast<size_t>(b) * d;
    float part = 0.0f;
    for (int i = tid; i < d; i += kThreads) part = fmaf(sq[i], knb[i], part);
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
  if (rank != 0) return;

  // rank 0: fold the ranks in rank order (a rank with no pages has m =
  // NEG_INF, l = 0, acc = 0), then the fresh row at logical position len,
  // last, so the softmax always has a valid entry and L > 0
  const float* racc0 = reinterpret_cast<const float*>(smem + lay.racc);
  const float* rstat0 = reinterpret_cast<const float*>(smem + lay.rstat);
  float M = kNegInf;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, rstat0[2 * i]);
  float w[kMaxSplit];
  float L = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxSplit; ++i) {
    if (i < nsplit) {
      w[i] = expf(rstat0[2 * i] - M);
      L = fmaf(w[i], rstat0[2 * i + 1], L);
    }
  }
  float a = 1.0f, pf = 0.0f;
  if (has_fresh) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    s *= scale;
    const float m_new = fmaxf(M, s);
    a = expf(M - m_new);
    pf = expf(s - m_new);
    L = L * a + pf;
  }
  const float* vnb = vn + static_cast<size_t>(b) * d;
  float* ob = out + static_cast<size_t>(b) * d;
#pragma unroll
  for (int x = 0; x < kMaxUnits; ++x) {
    const int u = tid + x * kThreads;
    if (u < U) {
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < kMaxSplit; ++i) {
        if (i < nsplit) fma4(o, w[i], reinterpret_cast<const float4*>(racc0 + i * d)[u]);
      }
      float res[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (has_fresh) {
          res[c] = (res[c] * a + pf * vnb[4 * u + c]) / L;
        } else {
          res[c] = L <= 0.0f ? 0.0f : res[c] / L;   // a stream that visited nothing: zeros
        }
      }
      reinterpret_cast<float4*>(ob)[u] = make_float4(res[0], res[1], res[2], res[3]);
    }
  }
}

}  // namespace split

}  // namespace

// The "simt" body: one block per stream.
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

// The "split" body: the same arguments as paged_decode_attention_f32, plus
// `nsplit`, the blocks of a cluster (1..16).  Besides the wrapper's checks it
// needs d % 4 == 0, d <= 2048, 16-byte aligned pools and its shared memory
// (two pages, q, acc, the scores) within 227 KB; it returns
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int paged_decode_attention_split_f32(
    const void* q, const void* kn, const void* vn, const void* k_pages,
    const void* v_pages, const void* tables, const void* lengths, void* out,
    int batch, int d, int ps, int npages, int has_fresh, float scale, int nsplit,
    void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const split::Layout lay(d, ps, nsplit);
  if (d % 4 != 0 || d > 4 * split::kMaxUnits * kThreads || ps < 1 || nsplit < 1 ||
      nsplit > split::kMaxSplit || lay.bytes > 227 * 1024 ||
      static_cast<long long>(batch) * nsplit >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      split::split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nsplit > 8) {
    err = cudaFuncSetAttribute(split::split_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // a stream's ranks: one cluster
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, split::split_kernel, static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), d, ps, npages, has_fresh,
      scale, nsplit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

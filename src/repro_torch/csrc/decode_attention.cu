// Dense flash-decode for Hopper (sm_90a): one query token per (b, q head)
// against a KV cache.  q in float32 or bfloat16, the cache in float32 or
// bfloat16 (independently), float32 statistics, output in q's type.
//
// Replaces the TPU kernel `decode_attention_kernel` -> `_decode_kernel` in
// src/repro/kernels/decode_attention.py (pallas_call at :93).  Same
// function: q (B,Hq,1,d) against k, v (B,Hkv,S,d); q head h reads kv head
// h / (Hq/Hkv); cache position kpos is visible iff kpos <= pos for the
// scalar pos; s = (q.k) * scale; a row with nothing visible (pos < 0) gives
// exact zeros.  pos is read from device memory (no host sync per step), and
// the cache is read through its strides, so the model's (B,S,Hkv,d) cache is
// attended in place, seen as (B,Hkv,S,d), and a decode step copies no cache.
//
// Bound.  About 4*d flops per visible cache row and query row against 2*d
// elements of K/V per visible cache row and kv head: 0.5-1.5 flops a byte,
// far below the ~20 at which even the CUDA cores (67 TFLOP/s float32) would
// limit, so the least time is the visible cache bytes over 3.35 TB/s:
//   dense step, q (8,15,1,64) bf16, float32 cache (8,545,5,64) at pos 528:
//     10.8 MB, 0.0032 ms
//   hybrid step, q (8,32,1,80) float32, cache (8,1057,32,80) at pos 1040:
//     170.6 MB, 0.0510 ms
// Tensor cores buy nothing here: the gain is in filling the 132 SMs and
// keeping enough bytes in flight.
//
// Two bodies, picked by the wrapper (decode_route):
//  * "split" (decode_attention_fwd_split), the path's body.  A thread-block
//    cluster of C blocks (C from the wrapper, fixed by the cache's dtype and
//    d, never by B; up to 16, the non-portable cluster size) takes each
//    (b, kv head) and all `group` query rows that share it, so each K/V row
//    is read once per group.  The visible keys, min(pos + 1, S), are cut into
//    64-key tiles, and rank r takes the contiguous run of tiles
//    [r*T/C, (r+1)*T/C); a rank with no tile contributes m = NEG_INF, l = 0.
//    A block of 256 threads streams its run through a ring of 16-byte
//    cp.async copies, as many tiles deep as the run, as far as two blocks an
//    SM allow (the copies of every tile of the ring in flight from the start;
//    short tiles zero-filled).  Per tile: scores by four threads a key, each
//    holding its quarter of q's columns in registers and reading K by 16-byte
//    shared loads; the tile's online softmax by a warp a query row; P.V by
//    threads that own four columns and a slice of the keys.  After the walk
//    the slices are folded in a fixed tree, each rank stores its (m, l, acc)
//    into rank 0's shared memory (distributed shared memory), and after one
//    cluster barrier rank 0 folds the ranks in rank order and writes o.
//    Rows of 16-byte multiples, d * sizeof(cache) <= 512, group <= 8 and q's
//    columns within a thread's registers (R * ceil(d / 16) <= 16, R the
//    group rounded up to a power of two).
//  * "simt" (decode_attention_fwd), the CUDA-core body of attention_tile.cuh
//    for every other shape: one block per (b, kv head, chunk of its group)
//    walks the cache in one sequence with scalar loads.
// Either body also writes, where the caller gives it an lse buffer (a null
// pointer leaves it out), each row's
// log-sum-exp of its scaled visible scores, m + ln(l) in natural-log units
// (the bodies exponentiate with expf), and -inf for a row with nothing
// visible: the statistic with which the calls over the slices of a cache
// split across ranks fold into the call over the whole
// (models/layers.py:decode_attend).  The simt body writes it from its
// running (m, l), the split body from rank 0's folded (M, L).
// Both keep the contract: a row's result depends only on its own q row, pos
// and the keys they name, summed in a fixed order with no atomics, so row b
// of a batched launch is bitwise equal to a solo launch of row b, and two
// launches on the same input are bitwise equal.
//
// Measured (chip_smoke.py, two runs, NVIDIA H100 80GB HBM3 at 700.00 W,
// cold L2): the dense step 0.0175-0.0177 ms against 0.0659-0.0664 on the
// simt body, the hybrid step 0.0816 against 0.1433.  The dense step is
// bound by latency, not bytes: pos is read before any tile can be asked
// for, and a rank's few tiles, the fold and the cluster barrier run one
// after another.

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// "simt": the CUDA-core body
// ---------------------------------------------------------------------------

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(attn::kThreads) decode_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k, const TKV* __restrict__ v,
    const int* __restrict__ pos, TQ* __restrict__ o, float* __restrict__ lse, int Hq,
    int Hkv, int S, int d, long long qsb, long long qsh, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, float scale, int bq,
    int bk) {
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
      /*zero_empty=*/true, smem, nullptr, nullptr,
      lse != nullptr ? lse + static_cast<long long>(b) * Hq + h0 : nullptr);
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* pos, void* o, int B,
           int Hq, int Hkv, int S, int d, long long qsb, long long qsh, long long ksb,
           long long ksh, long long kss, long long vsb, long long vsh, long long vss,
           float scale, float* lse, cudaStream_t stream) {
  const int group = Hq / Hkv;
  int bq = 0, bk = 0;
  if (!attn::pick_tile(d, group, &bq, &bk)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = attn::smem_bytes(bq, bk, d);
  cudaError_t err = attn::allow_smem(decode_attention_kernel<TQ, TKV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hkv, (group + bq - 1) / bq);
  decode_attention_kernel<TQ, TKV><<<grid, attn::kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(pos), static_cast<TQ*>(o), lse, Hq, Hkv, S, d, qsb, qsh, ksb,
      ksh, kss, vsb, vsh, vss, scale, bq, bk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "split": the cache split over a thread-block cluster
// ---------------------------------------------------------------------------

namespace split {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;                    // keys per tile
constexpr int kSub = kThreads / kKeys;       // threads per key in the scores
constexpr int kMaxRowBytes = 512;            // d * sizeof(cache) a tile row may take
constexpr int kMaxRows = 8;                  // query rows per kv head (one warp each)
constexpr int kMaxSplit = 16;                // blocks per cluster (non-portable above 8)
constexpr int kMaxStages = 8;                // tiles of the ring (cp_async_wait_pending)
constexpr int kQRegs = 16;                   // float4s of q a thread holds: R * ceil(d/16)
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kHalfSmem = 113 * 1024;       // two blocks an SM (1 KB of each reserved)
static_assert(kMaxRows <= kWarps, "the softmax takes one warp a query row");

// Shared memory (bytes) of a block with R query rows, cache rows of `rb`
// bytes, `nsplit` blocks a cluster and a ring of `stages` tiles:
//   ring   stages x (K tile, V tile), kKeys rows of rb + 16 bytes each (the
//          pad spreads a key's four readers over the banks); after the key
//          walk the same bytes hold the P.V fold, KS x R x d floats
//   sq     R x d       query rows, float32
//   sp     R x kKeys   scores, then probabilities
//   sm, sl, sa  R      running max, denominator, this tile's rescale
//   recv   nsplit x (R x d + 2R)  every rank's (acc, m, l), stored by the
//          ranks into rank 0's copy
struct Layout {
  int pitch, sq, sp, sm, sl, sa, racc, rstat;
  size_t bytes;
  __host__ __device__ Layout(int R, int d, int rb, int nsplit, int stages) {
    pitch = rb + 16;
    const int ring = stages * 2 * kKeys * pitch;
    const int fold = kThreads * 4 * R * 4;   // KS * d <= 4 * kThreads
    sq = ring > fold ? ring : fold;
    sp = sq + R * d * 4;
    sm = sp + R * kKeys * 4;
    sl = sm + R * 4;
    sa = sl + R * 4;
    racc = (sa + R * 4 + 15) / 16 * 16;
    rstat = racc + nsplit * R * d * 4;
    bytes = static_cast<size_t>(rstat + nsplit * 2 * R * 4);
  }
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& x) {
  a.x = fmaf(p, x.x, a.x);
  a.y = fmaf(p, x.y, a.y);
  a.z = fmaf(p, x.z, a.z);
  a.w = fmaf(p, x.w, a.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copy tile `t` (keys [t*kKeys, t*kKeys + kKeys) of the run, those past
// nkeys zero-filled) of K and V into one ring stage.
template <typename TKV>
__device__ __forceinline__ void load_tile(unsigned char* sk, const TKV* k, const TKV* v,
                                          long long kss, long long vss, int t, int nkeys,
                                          int rb, int pitch) {
  unsigned char* sv = sk + kKeys * pitch;
  const int pieces = rb / 16;
  for (int e = threadIdx.x; e < kKeys * pieces; e += kThreads) {
    const int j = e / pieces;
    const int c = (e - j * pieces) * 16;
    const int key = t * kKeys + j;
    const bool ok = key < nkeys;
    const long long row = ok ? key : 0;
    hopper::cp_async16(sk + j * pitch + c,
                       reinterpret_cast<const unsigned char*>(k + row * kss) + c, ok);
    hopper::cp_async16(sv + j * pitch + c,
                       reinterpret_cast<const unsigned char*>(v + row * vss) + c, ok);
  }
}

// A launch's arguments.  q and o are float32 or bfloat16 (q_bf16); q is read
// element by element (any strides), o is contiguous (B,Hq,1,d).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;
  int q_bf16, B, Hq, Hkv, S, d;
  long long qsb, qsh, ksb, ksh, kss, vsb, vsh, vss;
  float scale;
  int nsplit, stages;
  float* lse;    // (B,Hq) log-sum-exp of each row, or null: not written
};

// One block: rank `cluster_rank` of the cluster for unit blockIdx.x / nsplit
// = (b, kv head), query rows h0 .. h0 + group - 1, padded to R; each scores
// thread holds NG column groups of q per row (NG >= ceil(d / 16)).
template <typename TKV, int R, int NG>
__global__ void __launch_bounds__(kThreads, 2) split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = __ldg(a.pos);
  const int Hq = a.Hq, Hkv = a.Hkv, S = a.S, d = a.d, nsplit = a.nsplit, stages = a.stages;
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const long long kss = a.kss, vss = a.vss;
  const int rb = d * static_cast<int>(sizeof(TKV));
  const Layout lay(R, d, rb, nsplit, stages);
  float* sq = reinterpret_cast<float*>(smem + lay.sq);
  float* sp = reinterpret_cast<float*>(smem + lay.sp);
  float* sm = reinterpret_cast<float*>(smem + lay.sm);
  float* sl = reinterpret_cast<float*>(smem + lay.sl);
  float* sa = reinterpret_cast<float*>(smem + lay.sa);
  const int stage = 2 * kKeys * lay.pitch;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int unit = blockIdx.x / nsplit;
  const int b = unit / Hkv;
  const int kvh = unit - b * Hkv;
  const int group = Hq / Hkv;
  const int h0 = kvh * group;
  // q first: its loads need no pos, so they overlap pos's
  const long long q0 = b * a.qsb + h0 * a.qsh;
  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d;
    const long long i = q0 + r * a.qsh + e - r * d;
    float x = 0.0f;
    if (r < group) {
      x = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
                   : static_cast<const float*>(a.q)[i];
    }
    sq[e] = x;
  }
  if (tid < R) {
    sm[tid] = attn::kNegInf;
    sl[tid] = 0.0f;
  }
  const int nkeys = p < 0 ? 0 : (p < S - 1 ? p + 1 : S);
  const int ntiles = (nkeys + kKeys - 1) / kKeys;
  const int t0 = rank * ntiles / nsplit;
  const int t1 = (rank + 1) * ntiles / nsplit;
  const TKV* kb = k + b * a.ksb + kvh * a.ksh;
  const TKV* vb = v + b * a.vsb + kvh * a.vsh;

  // the ring: `stages` tiles in flight from the start, one commit group each
  // (empty past the run's end, so the count of groups stays fixed)
  for (int i = 0; i < stages; ++i) {
    if (t0 + i < t1) load_tile(smem + i * stage, kb, vb, kss, vss, t0 + i, nkeys, rb, lay.pitch);
    hopper::cp_async_commit();
  }

  // scores: kSub threads a key; sub-thread s owns the column groups
  // g = s + kSub*i (4 columns each) of every query row, held in registers
  static_assert(R * NG <= kQRegs, "q registers");
  const int G4 = d / 4;
  const int sub = tid % kSub;
  const int key = tid / kSub;
  __syncthreads();                             // sq
  float4 qr[R][NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = sub + kSub * i;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qr[r][i] = g < G4 ? load4(sq + r * d + 4 * g) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  // P.V: thread (slice, c4) owns columns 4*c4 .. 4*c4 + 3 of every row and
  // the keys j = slice, slice + KS, ... of each tile
  const int KS = kThreads / G4;
  const int slice = tid / G4;
  const int c4 = tid - slice * G4;
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int t = t0; t < t1; ++t) {
    const int i = (t - t0) % stages;
    unsigned char* sk = smem + i * stage;
    unsigned char* sv = sk + kKeys * lay.pitch;
    hopper::cp_async_wait_pending(stages - 1);   // this thread's copies of tile t
    __syncthreads();                             // everyone's
    const int nk = nkeys - t * kKeys < kKeys ? nkeys - t * kKeys : kKeys;

    // scores: the key's dot products over this thread's column groups,
    // summed over its kSub threads
    {
      const TKV* kr = reinterpret_cast<const TKV*>(sk + key * lay.pitch);
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = sub + kSub * i;
        if (g < G4) {
          const float4 kx = load4(kr + 4 * g);
#pragma unroll
          for (int r = 0; r < R; ++r) dot[r] = dot4(qr[r][i], kx, dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = dot[r];
#pragma unroll
        for (int off = 1; off < kSub; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (sub == 0) sp[r * kKeys + key] = key < nk ? x * a.scale : attn::kNegInf;
      }
    }
    __syncthreads();

    // the tile's online softmax: one warp a query row, two keys a lane
    if (warp < R) {
      const int r = warp;
      const float x0 = sp[r * kKeys + lane];
      const float x1 = sp[r * kKeys + lane + 32];
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, attn::warp_max(fmaxf(x0, x1)));
      const float p0 = lane < nk ? expf(x0 - m_new) : 0.0f;
      const float p1 = lane + 32 < nk ? expf(x1 - m_new) : 0.0f;
      sp[r * kKeys + lane] = p0;
      sp[r * kKeys + lane + 32] = p1;
      const float sum = attn::warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's keys
    if (slice < KS) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float alpha = sa[r];
        acc[r].x *= alpha;
        acc[r].y *= alpha;
        acc[r].z *= alpha;
        acc[r].w *= alpha;
      }
      for (int j = slice; j < nk; j += KS) {
        const float4 vx = load4(reinterpret_cast<const TKV*>(sv + j * lay.pitch) + 4 * c4);
#pragma unroll
        for (int r = 0; r < R; ++r) fma4(acc[r], sp[r * kKeys + j], vx);
      }
    }
    if (t + stages < t1) {
      __syncthreads();                           // stage i is free
      load_tile(sk, kb, vb, kss, vss, t + stages, nkeys, rb, lay.pitch);
    }
    hopper::cp_async_commit();
  }

  // fold the key slices' partial sums and store this rank's (acc, m, l)
  // into rank 0's recv (the fold buffer overlays the ring: the barrier waits
  // for its last readers)
  __syncthreads();
  float* fold = reinterpret_cast<float*>(smem);
  if (slice < KS) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(fold + (slice * R + r) * d + 4 * c4) = acc[r];
  }
  __syncthreads();
  const uint32_t racc = hopper::map_rank(hopper::smem_u32(smem + lay.racc), 0) +
                        static_cast<uint32_t>(rank * R * d * 4);
  // four lanes an element, each summing a quarter of the slices in order,
  // then the quarters by shuffles (every lane gets the same sum)
  for (int e0 = 0; e0 < R * G4; e0 += kThreads / 4) {
    const int e = e0 + tid / 4;
    const int q4 = tid % 4;
    const int r = e / G4;
    const int c = e - r * G4;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (e < R * G4) {
      for (int i = q4; i < KS; i += 4) {
        const float4 x = load4(fold + (i * R + r) * d + 4 * c);
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
    }
    if (e < R * G4 && q4 == 0) hopper::st_cluster4(racc + (r * d + 4 * c) * 4, s);
  }
  if (tid < R) {
    const uint32_t rstat = hopper::map_rank(hopper::smem_u32(smem + lay.rstat), 0) +
                           static_cast<uint32_t>(rank * 2 * R * 4);
    hopper::st_cluster(rstat + tid * 4, sm[tid]);
    hopper::st_cluster(rstat + (R + tid) * 4, sl[tid]);
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
  if (rank != 0) return;

  // rank 0: fold the ranks in rank order; a rank with no keys has m =
  // NEG_INF, l = 0, acc = 0
  const float* racc0 = reinterpret_cast<const float*>(smem + lay.racc);
  const float* rstat0 = reinterpret_cast<const float*>(smem + lay.rstat);
  for (int e = tid; e < group * G4; e += kThreads) {
    const int r = e / G4;
    const int c = e - r * G4;
    float M = attn::kNegInf;
    for (int i = 0; i < nsplit; ++i) M = fmaxf(M, rstat0[i * 2 * R + r]);
    float L = 0.0f;
    float4 O = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < nsplit; ++i) {
      const float w = expf(rstat0[i * 2 * R + r] - M);
      L = fmaf(w, rstat0[i * 2 * R + R + r], L);
      fma4(O, w, load4(racc0 + (i * R + r) * d + 4 * c));
    }
    // nothing visible (pos < 0): exact zeros, and a log-sum-exp of -inf
    const bool any = L > 0.0f;
    if (a.lse != nullptr && c == 0) {
      a.lse[static_cast<long long>(b) * Hq + h0 + r] = any ? M + logf(L) : -CUDART_INF_F;
    }
    const float res[4] = {any ? O.x / L : 0.0f, any ? O.y / L : 0.0f, any ? O.z / L : 0.0f,
                          any ? O.w / L : 0.0f};
    const long long at = (static_cast<long long>(b) * Hq + h0 + r) * d + 4 * c;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (a.q_bf16) {
        static_cast<__nv_bfloat16*>(a.o)[at + x] = __float2bfloat16(res[x]);
      } else {
        static_cast<float*>(a.o)[at + x] = res[x];
      }
    }
  }
}

template <typename TKV, int R, int NG>
int launch(Args a, cudaStream_t stream) {
  const int rb = a.d * static_cast<int>(sizeof(TKV));
  // the ring: as many tiles as a rank's longest run, as far as two blocks an
  // SM allow
  const int per_rank = ((a.S + kKeys - 1) / kKeys + a.nsplit - 1) / a.nsplit;
  a.stages = per_rank < kMaxStages ? (per_rank > 1 ? per_rank : 1) : kMaxStages;
  while (a.stages > 1 && Layout(R, a.d, rb, a.nsplit, a.stages).bytes > kHalfSmem) --a.stages;
  const Layout lay(R, a.d, rb, a.nsplit, a.stages);
  if (lay.bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = split_kernel<TKV, R, NG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.nsplit > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B) * a.Hkv * a.nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;   // a unit's ranks: one cluster
  attr[0].val.clusterDim.x = a.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// NG, the column groups of q a scores thread holds, from d: the least power
// of two >= ceil(d / 16) with R * NG <= kQRegs
template <typename TKV, int R>
int launch_groups(const Args& a, cudaStream_t stream) {
  const int ng = (a.d + 15) / 16;
  if (ng <= 1) return launch<TKV, R, 1>(a, stream);
  if (ng <= 2) return launch<TKV, R, 2>(a, stream);
  if constexpr (4 * R <= kQRegs) {
    if (ng <= 4) return launch<TKV, R, 4>(a, stream);
  }
  if constexpr (8 * R <= kQRegs) {
    if (ng <= 8) return launch<TKV, R, 8>(a, stream);
  }
  if constexpr (16 * R <= kQRegs) {
    if (ng <= 16) return launch<TKV, R, 16>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// R, the query rows a block holds, from the group: 3 (SmolLM-360M) takes 4
template <typename TKV>
int launch_rows(const Args& a, cudaStream_t stream) {
  const int group = a.Hq / a.Hkv;
  if (group <= 1) return launch_groups<TKV, 1>(a, stream);
  if (group <= 2) return launch_groups<TKV, 2>(a, stream);
  if (group <= 4) return launch_groups<TKV, 4>(a, stream);
  return launch_groups<TKV, 8>(a, stream);
}

}  // namespace split

template <typename TQ>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v, const void* pos,
              void* o, int B, int Hq, int Hkv, int S, int d, long long qsb, long long qsh,
              long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
              long long vss, float scale, float* lse, cudaStream_t stream) {
  if (kv_dtype == attn::kF32) {
    return launch<TQ, float>(q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb, ksh, kss,
                             vsb, vsh, vss, scale, lse, stream);
  }
  if (kv_dtype == attn::kBF16) {
    return launch<TQ, __nv_bfloat16>(q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb,
                                     ksh, kss, vsb, vsh, vss, scale, lse, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (B,Hq,1,d) with element strides (qsb, qsh, -, 1); k, v: (B,Hkv,S,d)
// with strides (ksb, ksh, kss, 1) and (vsb, vsh, vss, 1); pos: one int32 on
// the device; o: contiguous (B,Hq,1,d) in q's type; lse: contiguous (B,Hq)
// float32, each row's log-sum-exp of its scaled visible scores (m + ln l in
// natural-log units, -inf for a row with nothing visible), or null: not
// written.  Types: 0 float32, 1 bfloat16.  The wrapper checks shapes, types,
// devices and strides; this returns a CUDA error code.  The "simt" body.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, int q_dtype, int kv_dtype,
                                    int B, int Hq, int Hkv, int S, int d, long long qsb,
                                    long long qsh, long long ksb, long long ksh,
                                    long long kss, long long vsb, long long vsh,
                                    long long vss, float scale, void* lse, void* stream) {
  if (B == 0 || Hq == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (q_dtype == attn::kF32) {
    return launch_kv<float>(kv_dtype, q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh, ksb,
                            ksh, kss, vsb, vsh, vss, scale, l, s);
  }
  if (q_dtype == attn::kBF16) {
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, pos, o, B, Hq, Hkv, S, d, qsb, qsh,
                                    ksb, ksh, kss, vsb, vsh, vss, scale, l, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "split" body: the same arguments as decode_attention_fwd, plus
// `nsplit`, the blocks of a cluster (1..16), before `lse`.  Besides the
// wrapper's checks it needs d * sizeof(cache) a multiple of 16 and at most
// 512, Hq / Hkv <= 8 with R * ceil(d / 16) <= 16 (R: Hq / Hkv rounded up to
// 1, 2, 4 or 8), and k, v at 16-byte aligned bases and strides; it returns
// cudaErrorInvalidValue for a shape it does not take.  Rank 0 of each
// cluster writes the rows' log-sum-exp from its folded (M, L).
extern "C" int decode_attention_fwd_split(const void* q, const void* k, const void* v,
                                          const void* pos, void* o, int q_dtype,
                                          int kv_dtype, int B, int Hq, int Hkv, int S, int d,
                                          long long qsb, long long qsh, long long ksb,
                                          long long ksh, long long kss, long long vsb,
                                          long long vsh, long long vss, float scale,
                                          int nsplit, void* lse, void* stream) {
  if (B == 0 || Hq == 0 || d == 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int group = Hq / Hkv;
  const int rb = d * (kv_dtype == attn::kBF16 ? 2 : 4);
  if ((q_dtype != attn::kF32 && q_dtype != attn::kBF16) || rb % 16 != 0 ||
      rb > split::kMaxRowBytes || group > split::kMaxRows || nsplit < 1 ||
      nsplit > split::kMaxSplit || static_cast<long long>(B) * Hkv * nsplit >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const split::Args a = {q,   k,   v,   static_cast<const int*>(pos), o, q_dtype == attn::kBF16,
                         B,   Hq,  Hkv, S,   d,   qsb, qsh, ksb, ksh, kss, vsb, vsh, vss,
                         scale, nsplit, 0, static_cast<float*>(lse)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == attn::kF32) return split::launch_rows<float>(a, s);
  if (kv_dtype == attn::kBF16) return split::launch_rows<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The SSD chunked scan on the tensor cores for Hopper (sm_90a): the body of
// ssm_scan.cu's "mma" route (ssd_scan_fwd_mma), for float32 and bfloat16 at
// N and P multiples of 8 up to 64 and a chunk no longer than kMaxChunk
// below gives (at N = 64: 256 rows in float32, 640 in bfloat16, the most
// whose tiles fit one block's shared memory).  The CUDA-core body in
// ssm_scan.cu takes every other shape.
//
// Same function as the CUDA-core body, chunk by chunk of Q rows:
//   y_i = sum_{j<=i} (C_i.B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i.S_prev
//   S   = exp(cs_last) S_prev + sum_j B_j (x) exp(cs_last - cs_j) dt_j x_j
// with cs the cumulative sum of dt*A over the chunk; float32 math, y in x's
// type, the final state float32.
//
// The intra-chunk term is causal attention with the softmax replaced by a
// decay mask: q = C, k = B, v = x, and p_ij = (C_i.B_j) exp(cs_i - cs_j)
// dt_j selected at j <= i.  Every product runs on mma.sync (tf32_mma.cuh)
// with float32 accuracy: a float32 operand is split into TF32 hi + lo, and
// a bfloat16 operand is exact (lo = 0), so only the terms with a float32
// lo run.  In bfloat16, dt rides with p and with the end-of-chunk weight
// w_j = exp(cs_last - cs_j), never with x, so x stays exact:
//                      bfloat16                     float32
//   C.B^T              1 bf16 m16n8k16 (exact)      3 TF32 terms
//   p.x  / p.(dt x)    2 TF32 terms (p split)       3
//   C.S_prev           2 TF32 terms (S split)       3
//   (B w dt)^T.x       2 TF32 terms                 3 (B^T.(w dt x))
//
// Bound.  At the Zamba2 prefill's x (8,1024,80,64) bf16, chunk 256: 183.0
// MB of x, dt, B, C, y and the final state (0.0546 ms at 3.35 TB/s) against
// 20.17 GFLOP of the three products with a float32 operand (p.x, the state
// update, and C.S_prev in every chunk but the first, where S_prev = 0), at
// the rate of the two TF32 terms each needs in bfloat16 (494/2 TFLOP/s on
// the H100 SXM): 0.0817 ms, operations bound it.  In float32 the same
// products take three terms (494/3).  C.B^T is 0.135 GFLOP if formed once
// per (b, chunk), 10.78 counted per head.  mma.sync does not reach the
// dense peaks, which are wgmma's.
//
// Design.
//  * One block of eight warps per (b, h), walking the chunks in order with
//    the (N, P) state in shared memory between them (the TPU's sequential
//    chunk axis).  In bfloat16 a block takes 110.6 KB at Q = 256 (x and B
//    as loaded, C in registers) and at most 128 registers a thread, so two
//    blocks share an SM and one's loads overlap the other's products:
//    640 blocks at (8,1024,80,64), 2.4 waves on 132 SMs.  Float32 keeps B,
//    C and dt*x in float32, 230.4 KB, one block an SM.
//  * A chunk's loads are all in flight at once, by cp.async (16 bytes; dt
//    4), one wait: rows past the chunk's end and columns past N or P
//    zero-filled, so every product runs unguarded over whole tiles.  B and
//    C are indexed by batch and x and y go through the model's strides;
//    the 16-byte copies need 16-byte aligned bases and strides, which the
//    wrapper checks (it raises, it never falls back).
//  * cs is a scan in warp 0 in fixed order: each lane sums a run of R/32
//    rows, the runs' totals are scanned by shuffles.  It is kept times
//    log2(e), so every decay is one ex2; exp(cs_i - cs_j) is 1 exactly on
//    the diagonal.
//  * Query strips of 16 rows, balanced over the causal triangle: in each
//    group of 16 strips warp w takes strip w and strip 15 - w (17 strips'
//    worth of key steps each at Q = 256).  A strip's y is C.S_prev times
//    exp(cs_i) (skipped in the first chunk, where S_prev = 0), then, per
//    64-key tile up to the strip's last row, the 16 x 64 scores C.B^T in
//    registers, the decay selected at j <= i (pairs above the diagonal get
//    0 and their exp is never used: exp(cs_i - cs_j) for j > i can be inf,
//    and inf*0 is NaN), and p.x added on; 8-key steps wholly above the
//    strip are skipped.
//  * Fragments.  bf16 C rows go from global memory straight into m16n8k16
//    A registers, once per strip, and serve C.B^T as they stand and
//    C.S_prev as two TF32 k-steps (k-slots renumbered to the bf16 halves).
//    B tiles come by ldmatrix, x tiles by ldmatrix.trans, which hands each
//    lane x rows 2t and 2t+1 of a column packed in one register: the B
//    fragment of a TF32 step whose k-slot t is key 2t and k-slot t+4 key
//    2t+1.  p feeds p.x from the score registers as they stand under that
//    renumbering (as attention_tf32.cuh does), and the state update reads
//    B transposed with it.  Float32 reads fragments element by element.
//  * The bf16 state is kept as its TF32 (hi, lo) pairs, split once per
//    chunk by the state update rather than once per strip by C.S_prev.
//  * Rows are padded so that fragment reads hit distinct banks: B and C
//    rows by 4 floats or 8 bf16, x rows to 68 floats or 72 bf16, state
//    rows to 72 floats or 66 pairs.
//  * The state update: eight warps over the (N, P) state's 16 x 32 tiles,
//    each starting from exp(cs_last) S_prev and adding the chunk's keys.
//  * Accumulation.  The tensor cores truncate as they add into a float32
//    accumulator; a y row sums at most Q/8 * 3 + N/8 * 3 products into one
//    accumulator (120 at Q = 256, N = 64), inside the 2e-4 float32 gate.
//  * Determinism.  Fixed order everywhere, no atomics, tiles from (Q, N, P)
//    alone: row b of a batched launch is bitwise equal to a solo launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace ssd_mma {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;                // columns of x, y and the state held: P <= 64
constexpr int kMaxN = 64;                // state dims held: N <= 64
constexpr int kKeys = 64;                // keys per score tile
constexpr size_t kMaxSmem = 227 * 1024;  // per block on the H100

// Shared memory of a block, each piece 16-byte aligned: the state (Npad
// rows of lds floats), x (R rows of ldx elements: bf16 as loaded, or
// float32 dt*x), B (R rows of ld elements), C (float32 only: bf16 C
// fragments go from global memory to registers), then cs, dt and w (R
// floats each).  R is Q rounded up to a score tile, Npad N rounded up to
// an m16 tile.  Row paddings keep fragment reads free of bank conflicts.
struct Layout {
  int rows, npad, ld, ldx, lds;
  size_t x, b, c, cs, dt, w, bytes;
};

__host__ __device__ constexpr Layout layout(int Q, int N, int esize) {
  const bool bf16 = esize == 2;
  Layout l{};
  l.rows = (Q + kKeys - 1) / kKeys * kKeys;
  l.npad = (N + 15) / 16 * 16;
  l.ld = l.npad + (bf16 ? 8 : 4);
  l.ldx = kCols + (bf16 ? 8 : 4);
  l.lds = kCols + (bf16 ? 2 : 8);        // bf16: (hi, lo) pairs of 8 bytes
  l.x = static_cast<size_t>(l.npad) * l.lds * (bf16 ? 8 : 4);
  l.b = l.x + static_cast<size_t>(l.rows) * l.ldx * esize;
  l.c = l.b + static_cast<size_t>(l.rows) * l.ld * esize;
  l.cs = l.c + (bf16 ? 0 : static_cast<size_t>(l.rows) * l.ld * esize);
  l.dt = l.cs + static_cast<size_t>(l.rows) * 4;
  l.w = l.dt + static_cast<size_t>(l.rows) * 4;
  l.bytes = l.w + static_cast<size_t>(l.rows) * 4;
  return l;
}

// The longest chunk the body takes, by type (bfloat16, float32) and N
// rounded up to 16 (16, 32, 48, 64): the most rows, in whole score tiles,
// whose layout() fits kMaxSmem (bfloat16 at N = 64: 640 rows in 225.8 KB,
// 110.6 KB at 256; float32: 256 rows in 230.4 KB).  The wrapper's
// ssd_route routes by the same numbers (kernels/ssm_scan.py:
// MMA_MAX_CHUNK), which chip_smoke.py and a gpu test hold to
// ssd_scan_mma_max_chunk; the static_assert holds the table to layout().
constexpr int kMaxChunk[2][4] = {{1088, 896, 768, 640}, {512, 384, 256, 256}};

constexpr bool max_chunk_is_layouts() {
  for (int e = 0; e < 2; ++e) {
    for (int k = 0; k < 4; ++k) {
      const int esize = e == 0 ? 2 : 4;
      const int q = kMaxChunk[e][k];
      if (q % kKeys != 0 || layout(q, 16 * (k + 1), esize).bytes > kMaxSmem ||
          layout(q + kKeys, 16 * (k + 1), esize).bytes <= kMaxSmem) {
        return false;
      }
    }
  }
  return true;
}
static_assert(max_chunk_is_layouts(), "kMaxChunk must be the longest chunk layout() fits");

// The longest chunk the body takes at (esize, N), 0 at an N it does not take.
constexpr int max_chunk(int esize, int N) {
  return N >= 8 && N % 8 == 0 && N <= kMaxN && (esize == 2 || esize == 4)
             ? kMaxChunk[esize == 2 ? 0 : 1][(N + 15) / 16 - 1]
             : 0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c += a.b on one m16n8k16 bf16 tile, float32 accumulator (products exact).
// A: a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9), a3 (g+8,
// 2t+8..2t+9); B: b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g); two bf16
// values a register, the lower column in the low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles of shared memory, lanes 8m..8m+7 giving the row
// addresses of tile m.  Plain: lane (g, t) gets row g, columns 2t and 2t+1
// of each tile; .trans: rows 2t and 2t+1 of column g.  The lower row or
// column is in the low half.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tf32::smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tf32::smem_u32(p)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The low and high bf16 of a register as TF32 bit patterns (exact).
__device__ __forceinline__ uint32_t lo_bf16(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t hi_bf16(uint32_t v) { return v & 0xffff0000u; }

// The TF32 (hi, lo) halves of four A-fragment values.
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32::split(a[i], hi[i], lo[i]);
}

// The A fragment at p = &tile[row g][col t] of a row-major tile with rows of
// ld elements: (g, t), (g+8, t), (g, t+4), (g+8, t+4).
__device__ __forceinline__ void frag_a(const float* p, int ld, float (&a)[4]) {
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// c[n] += a.b[n] over NT n-tiles in as many TF32 terms as the operands
// need: a_lo.b_hi unless a is exact, a_hi.b_lo unless b is exact, then
// a_hi.b_hi; each term a pass over the n-tiles, so that consecutive mma
// instructions are independent.  bh[n], bl[n]: the halves of n-tile n's B
// fragment (k-slots t and t+4).
template <int NT, bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_split(float (*c)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
  if constexpr (!kAExact) {
#pragma unroll
    for (int n = 0; n < NT; ++n) tf32::mma(c[n], al, bh[n][0], bh[n][1]);
  }
  if constexpr (!kBExact) {
#pragma unroll
    for (int n = 0; n < NT; ++n) tf32::mma(c[n], ah, bl[n][0], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) tf32::mma(c[n], ah, bh[n][0], bh[n][1]);
}

// The same with B given as float32 values (k-slots t and t+4), split here;
// A split too: three terms.
template <int NT>
__device__ __forceinline__ void mma_n(float (*c)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const float (&b)[NT][2]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    tf32::split(b[n][0], bh[n][0], bl[n][0]);
    tf32::split(b[n][1], bh[n][1], bl[n][1]);
  }
  mma_split<NT, false, false>(c, ah, al, bh, bl);
}

// The same with B from four bf16 registers of ldsm4_trans (n-tile n: k-slot
// t the low half, t+4 the high half), exact in TF32, and A split: two terms.
__device__ __forceinline__ void mma_x4(float (*c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&r)[4]) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bh[n][0] = lo_bf16(r[n]);
    bh[n][1] = hi_bf16(r[n]);
    bl[n][0] = bl[n][1] = 0u;
  }
  mma_split<4, false, true>(c, ah, al, bh, bl);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1) scan_kernel(
    const T* __restrict__ x, long long xsb, long long xst, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dst, long long dsh,
    const float* __restrict__ A, const T* __restrict__ Bm, long long bsb, long long bst,
    const T* __restrict__ Cm, long long csb, long long cst, T* __restrict__ y,
    long long ysb, long long yst, long long ysh, float* __restrict__ s_out, int T_len,
    int H, int P, int N, int Q) {
  constexpr bool kBf16 = sizeof(T) == 2;    // bf16 operands are exact in TF32
  constexpr int kE = 16 / sizeof(T);       // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(Q, N, sizeof(T));
  const int ld = lay.ld;
  const int ldx = lay.ldx;
  const int lds = lay.lds;
  float* sS = reinterpret_cast<float*>(smem);        // float32: the state
  uint2* sSs = reinterpret_cast<uint2*>(smem);       // bf16: the state as (hi, lo)
  T* sX = reinterpret_cast<T*>(smem + lay.x);      // bf16: x; float32: dt*x
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  float* sC = reinterpret_cast<float*>(smem + lay.c);   // float32 only
  float* sCs = reinterpret_cast<float*>(smem + lay.cs);   // cs * log2(e)
  float* sDt = reinterpret_cast<float*>(smem + lay.dt);
  float* sW = reinterpret_cast<float*>(smem + lay.w);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float a = A[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  T* yb = y + b * ysb + h * ysh;
  const int R = lay.rows;
  const int nks = N / 8;                   // 8-wide k-steps over the state dim
  const int nk16 = lay.npad / 16;          // 16-wide k-steps (zero past N)

  for (int i = tid; i < lay.npad * lds * (kBf16 ? 2 : 1); i += kThreads) sS[i] = 0.0f;

  for (int t0 = 0; t0 < T_len; t0 += Q) {
    const int L = T_len - t0 < Q ? T_len - t0 : Q;   // a short last chunk as it is
    __syncthreads();   // the previous chunk's readers are done
    // every load of the chunk in flight at once, by cp.async, zero past row
    // L and columns N and P: B (and float32 C) rows, x rows and dt; rows
    // past L get dt = 0, inert (decay 1, update 0)
    const int bpieces = lay.npad / kE;
    for (int e = tid; e < R * bpieces; e += kThreads) {
      const int r = e / bpieces;
      const int c = (e - r * bpieces) * kE;
      const bool ok = r < L && c < N;
      const long long row = static_cast<long long>(t0 + r);
      tf32::cp_async16(sB + r * ld + c, ok ? Bb + row * bst + c : Bb, ok);
      if constexpr (!kBf16) {
        tf32::cp_async16(sC + r * ld + c, ok ? Cb + row * cst + c : Cb, ok);
      }
    }
    constexpr int xpieces = kCols / kE;
    for (int e = tid; e < R * xpieces; e += kThreads) {
      const int r = e / xpieces;
      const int c = (e - r * xpieces) * kE;
      const bool ok = r < L && c < P;
      tf32::cp_async16(sX + r * ldx + c,
                       ok ? xb + static_cast<long long>(t0 + r) * xst + c : xb, ok);
    }
    for (int j = tid; j < R; j += kThreads) {
      tf32::cp_async4(sDt + j, j < L ? dtb + static_cast<long long>(t0 + j) * dst : dtb, j < L);
    }
    tf32::cp_async_commit();
    tf32::cp_async_wait_all();
    __syncthreads();
    // cs = cumsum(dt * a): each lane of warp 0 a run of R/32 rows, the runs'
    // totals scanned across the warp, all in fixed order; kept as cs *
    // log2(e), the argument of ex2
    if (warp == 0) {
      const int per = R / 32;
      const int j0 = lane * per;
      float run = 0.0f;
      for (int k = 0; k < per; ++k) run = __fadd_rn(run, __fmul_rn(sDt[j0 + k], a));
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, o);
      }
      float c = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) c = 0.0f;
      for (int k = 0; k < per; ++k) {
        c = __fadd_rn(c, __fmul_rn(sDt[j0 + k], a));
        sCs[j0 + k] = c * kLog2e;
      }
    }
    if constexpr (!kBf16) {
      // float32: dt*x in place (bf16 keeps x exact and puts dt on p and w)
      for (int e = tid; e < R * xpieces; e += kThreads) {
        const int r = e / xpieces;
        float4* to = reinterpret_cast<float4*>(sX + r * ldx + (e - r * xpieces) * kE);
        const float d = sDt[r];
        const float4 v = *to;
        *to = make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
      }
    }
    __syncthreads();   // B, C, x and cs are in place
    // end-of-chunk weights w_j = exp(cs_last - cs_j), times dt_j for bf16
    const float last = sCs[L - 1];
    for (int j = tid; j < R; j += kThreads) {
      sW[j] = kBf16 ? ex2(last - sCs[j]) * sDt[j] : ex2(last - sCs[j]);
    }

    // y, strip by strip: warp w takes strips w and 15 - w of each 16
    for (int s16 = 0; s16 * 16 < L; s16 += 16) {
      for (int half = 0; half < 2; ++half) {
        const int r0 = 16 * (s16 + (half == 0 ? warp : 15 - warp));
        if (r0 >= L) continue;
        const float ci0 = sCs[r0 + g];
        const float ci1 = sCs[r0 + g + 8];
        // bf16: the strip's C rows as m16n8k16 A fragments, from global
        // memory into registers, for C.B^T and C.S_prev (0 past L and N)
        uint32_t cf[kMaxN / 16][4];
        if constexpr (kBf16) {
#pragma unroll
          for (int k = 0; k < kMaxN / 16; ++k) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = r0 + g + 8 * (i & 1);
              const int col = 16 * k + 2 * t + 8 * (i >> 1);
              cf[k][i] = k < nk16 && row < L && col < N
                             ? __ldg(reinterpret_cast<const unsigned int*>(
                                   Cb + static_cast<long long>(t0 + row) * cst + col))
                             : 0u;
            }
          }
        }
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
        if (t0 > 0) {
          // acc = exp(cs_i) C_i . S_prev
          if constexpr (kBf16) {
            // each 16-state step as two TF32 k-steps: k-slot t is state
            // 16k + 2t (+8 in the second), k-slot t+4 the state after it,
            // the bf16 halves of the fragment registers as they stand
#pragma unroll
            for (int k = 0; k < kMaxN / 16; ++k) {
              if (k >= nk16) break;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t w0 = cf[k][2 * e], w1 = cf[k][2 * e + 1];
                const uint32_t ah[4] = {lo_bf16(w0), lo_bf16(w1), hi_bf16(w0), hi_bf16(w1)};
                const uint32_t al[4] = {0u, 0u, 0u, 0u};
                const uint2* sr = sSs + (16 * k + 2 * t + 8 * e) * lds + g;
                uint32_t bh[8][2], bl[8][2];
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                  const uint2 v0 = sr[n * 8], v1 = sr[lds + n * 8];
                  bh[n][0] = v0.x;
                  bl[n][0] = v0.y;
                  bh[n][1] = v1.x;
                  bl[n][1] = v1.y;
                }
                mma_split<8, true, false>(acc, ah, al, bh, bl);
              }
            }
          } else {
            for (int ks = 0; ks < nks; ++ks) {
              float af[4];
              uint32_t ah[4], al[4];
              frag_a(sC + (r0 + g) * ld + ks * 8 + t, ld, af);
              split4(af, ah, al);
              const float* sr = sS + (ks * 8 + t) * lds + g;
              float bf[8][2];
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                bf[n][0] = sr[n * 8];
                bf[n][1] = sr[4 * lds + n * 8];
              }
              mma_n<8>(acc, ah, al, bf);
            }
          }
          const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[n][0] *= e0;
            acc[n][1] *= e0;
            acc[n][2] *= e1;
            acc[n][3] *= e1;
          }
        }
        // intra-chunk: 64-key tiles up to the strip's last row r0 + 15
        for (int kt0 = 0; kt0 <= r0 + 15; kt0 += kKeys) {
          float s[8][4];
#pragma unroll
          for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
          if constexpr (kBf16) {
            // C.B^T on bf16 m16n8k16, exact products; B fragments by
            // ldmatrix, two key n-tiles a load
            const T* bl = sB + (kt0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld +
                          ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int k = 0; k < kMaxN / 16; ++k) {
              if (k >= nk16) break;
#pragma unroll
              for (int np = 0; np < 4; ++np) {
                uint32_t r[4];
                ldsm4(r, bl + np * 16 * ld + 16 * k);
                mma_bf16(s[2 * np], cf[k], r[0], r[1]);
                mma_bf16(s[2 * np + 1], cf[k], r[2], r[3]);
              }
            }
          } else {
            // C.B^T in 3xTF32
            for (int ks = 0; ks < nks; ++ks) {
              float af[4];
              uint32_t ah[4], al[4];
              frag_a(sC + (r0 + g) * ld + ks * 8 + t, ld, af);
              split4(af, ah, al);
              const float* br = reinterpret_cast<const float*>(sB) + (kt0 + g) * ld + ks * 8 + t;
              float bf[8][2];
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                bf[n][0] = br[n * 8 * ld];
                bf[n][1] = br[n * 8 * ld + 4];
              }
              mma_n<8>(s, ah, al, bf);
            }
          }
          // p = scores * exp(cs_i - cs_j) (times dt_j for bf16), selected at
          // j <= i
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int j = kt0 + n * 8 + 2 * t;
            const float2 cj = *reinterpret_cast<const float2*>(sCs + j);
            float2 dj = make_float2(1.0f, 1.0f);
            if constexpr (kBf16) dj = *reinterpret_cast<const float2*>(sDt + j);
            s[n][0] = j <= r0 + g ? s[n][0] * ex2(ci0 - cj.x) * dj.x : 0.0f;
            s[n][1] = j + 1 <= r0 + g ? s[n][1] * ex2(ci0 - cj.y) * dj.y : 0.0f;
            s[n][2] = j <= r0 + g + 8 ? s[n][2] * ex2(ci1 - cj.x) * dj.x : 0.0f;
            s[n][3] = j + 1 <= r0 + g + 8 ? s[n][3] * ex2(ci1 - cj.y) * dj.y : 0.0f;
          }
          // acc += p . (dt x); k-slot t is key 2t, k-slot t+4 key 2t+1
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kt0 + kk * 8 > r0 + 15) break;   // wholly above the strip
            const float pf[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
            uint32_t ph[4], pl[4];
            split4(pf, ph, pl);
            const int key = kt0 + kk * 8;
            if constexpr (kBf16) {
              // x rows 2t and 2t+1 of each column by ldmatrix.trans: exact
              const T* xr = sX + (key + (lane & 7)) * ldx + (lane >> 3) * 8;
              uint32_t r0x[4], r1x[4];
              ldsm4_trans(r0x, xr);
              ldsm4_trans(r1x, xr + 32);
              mma_x4(acc, ph, pl, r0x);
              mma_x4(acc + 4, ph, pl, r1x);
            } else {
              const float* xr = reinterpret_cast<const float*>(sX) + (key + 2 * t) * ldx + g;
              float bf[8][2];
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                bf[n][0] = xr[n * 8];
                bf[n][1] = xr[ldx + n * 8];
              }
              mma_n<8>(acc, ph, pl, bf);
            }
          }
        }
        // y rows r0 + g and r0 + g + 8, columns 8n + 2t and 8n + 2t + 1
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + g + 8 * i;
          if (row >= L) continue;
          T* yr = yb + static_cast<long long>(t0 + row) * yst + 2 * t;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n * 8 < P) store2(yr + n * 8, acc[n][2 * i], acc[n][2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();   // every y strip has read S_prev; sW is in place

    // S = exp(cs_last) S_prev + (B w)^T . (dt x), in 16 x 32 tiles of the
    // state; k-slot t is key 2t, t+4 key 2t+1
    const float decay = ex2(last);
    const int nkk = (L + 7) / 8;
    for (int u = warp; u < (lay.npad / 16) * 2; u += kWarps) {
      const int m0 = (u >> 1) * 16;
      const int n0 = (u & 1) * 32;
      if (n0 >= P) continue;                 // columns past P stay 0
      float c[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = (m0 + g + 8 * i) * lds + n0 + n * 8 + 2 * t;
          if constexpr (kBf16) {
            const uint4 v = *reinterpret_cast<const uint4*>(sSs + at);
            c[n][2 * i] = (__uint_as_float(v.x) + __uint_as_float(v.y)) * decay;
            c[n][2 * i + 1] = (__uint_as_float(v.z) + __uint_as_float(v.w)) * decay;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(sS + at);
            c[n][2 * i] = v.x * decay;
            c[n][2 * i + 1] = v.y * decay;
          }
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < nkk; ++kk) {
        const int k0 = kk * 8 + 2 * t;
        const T* br = sB + k0 * ld + m0 + g;
        const float w0 = sW[k0], w1 = sW[k0 + 1];
        if constexpr (kBf16) {
          // A = B^T w dt (float32, split), B = x (exact, by ldmatrix.trans)
          const float af[4] = {to_f32(br[0]) * w0, to_f32(br[8]) * w0, to_f32(br[ld]) * w1,
                               to_f32(br[ld + 8]) * w1};
          uint32_t ah[4], al[4];
          split4(af, ah, al);
          uint32_t r[4];
          ldsm4_trans(r, sX + (kk * 8 + (lane & 7)) * ldx + n0 + (lane >> 3) * 8);
          mma_x4(c, ah, al, r);
        } else {
          const float af[4] = {to_f32(br[0]), to_f32(br[8]), to_f32(br[ld]), to_f32(br[ld + 8])};
          uint32_t ah[4], al[4];
          split4(af, ah, al);
          const float* xr = reinterpret_cast<const float*>(sX) + k0 * ldx + n0 + g;
          float bf[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            bf[n][0] = xr[n * 8] * w0;
            bf[n][1] = xr[ldx + n * 8] * w1;
          }
          mma_n<4>(c, ah, al, bf);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int at = (m0 + g + 8 * i) * lds + n0 + n * 8 + 2 * t;
          if constexpr (kBf16) {
            uint32_t h0, l0, h1, l1;
            tf32::split(c[n][2 * i], h0, l0);
            tf32::split(c[n][2 * i + 1], h1, l1);
            *reinterpret_cast<uint4*>(sSs + at) = make_uint4(h0, l0, h1, l1);
          } else {
            *reinterpret_cast<float2*>(sS + at) = make_float2(c[n][2 * i], c[n][2 * i + 1]);
          }
        }
      }
    }
  }

  if (s_out != nullptr) {
    __syncthreads();
    float* so = s_out + static_cast<long long>(blockIdx.x) * N * P;
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P;
      const int at = n * lds + (i - n * P);
      so[i] = kBf16 ? __uint_as_float(sSs[at].x) + __uint_as_float(sSs[at].y) : sS[at];
    }
  }
}

// Whether the body takes (esize, N, P, Q): the wrapper's ssd_route mirrors it.
inline bool fits(int esize, int N, int P, int Q) {
  return P >= 8 && P % 8 == 0 && P <= kCols && Q >= 1 && Q <= max_chunk(esize, N);
}

template <typename T>
int launch(const void* x, long long xsb, long long xst, long long xsh, const float* dt,
           long long dsb, long long dst, long long dsh, const float* A, const void* Bm,
           long long bsb, long long bst, const void* Cm, long long csb, long long cst,
           void* y, long long ysb, long long yst, long long ysh, float* s_out, int batch,
           int T_len, int H, int P, int N, int Q, cudaStream_t stream) {
  if (!fits(sizeof(T), N, P, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(Q, N, sizeof(T)).bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<T><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), xsb, xst, xsh, dt, dsb, dst, dsh, A,
      static_cast<const T*>(Bm), bsb, bst, static_cast<const T*>(Cm), csb, cst,
      static_cast<T*>(y), ysb, yst, ysh, s_out, T_len, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_mma

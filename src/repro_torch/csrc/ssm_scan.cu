// Mamba2 SSD chunked scan for Hopper (sm_90a): x (B,T,H,P) in float32 or
// bfloat16, dt (B,T,H) float32, A (H,) float32, B and C (B,T,N) in x's type,
// shared across heads; y (B,T,H,P) in x's type and, optionally, the final
// state (B,H,N,P) float32.  All math in float32.
//
// Replaces the TPU kernel `ssd_scan_kernel` -> `_ssd_kernel` in
// src/repro/kernels/ssm_scan.py (pallas_call at :80).  Same function:
//   S_t = exp(dt_t*A) S_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . S_t,
// in the chunked form of models/mamba2.py:ssd_chunked, chunk by chunk of Q:
//   cs     = cumsum(dt*A) over the chunk
//   y_i    = sum_{j<=i} (C_i.B_j) exp(cs_i - cs_j) dt_j x_j + exp(cs_i) C_i.S_prev
//   S      = exp(cs_last) S_prev + sum_j exp(cs_last - cs_j) B_j (x) dt_j x_j
//
// Two routes, chosen by the wrapper (kernels/ssm_scan.py:ssd_route) from
// (dtype, N, P, chunk) alone, never from the batch or T:
//   * ssd_scan_fwd_mma: float32 and bfloat16 at N and P multiples of 8 up
//     to 64 and a chunk up to ssd_scan_mma_max_chunk(dtype, N), the most
//     rows whose tiles fit one block's shared memory (every path shape:
//     the Zamba2 prefill's (8,1024,80,64) bf16, its float32 gate at T =
//     300 and 304, chunk 256), on the tensor-core body of ssd_mma.cuh:
//     mma.sync products with float32 accuracy (a float32 operand split
//     into TF32 hi + lo, bf16 operands exact: C.B^T on bf16 m16n8k16, the
//     rest in two TF32 terms in bf16 and three in float32), a chunk loaded
//     by cp.async in one wait, 16-row query strips balanced over the causal
//     triangle, two blocks an SM in bf16.  The wrapper raises where 16-byte
//     copies cannot address x, B or C; it never falls back.
//   * ssd_scan_fwd: other shapes, on the CUDA-core body below, the port's
//     first, kept as it was; chip_smoke.py also times it beside the
//     tensor-core body through this entry.
//
// Bound.  Per (b, h) and chunk of n rows: n(n+1)*P flops of p.(dt x),
// 2nNP of the state update and, after the first chunk (S_prev = 0 before
// it), 2nNP of C.S_prev, all products with a float32 operand, against
// reading x, dt, B, C and writing y and the final state once; C.B^T
// (n(n+1)*N) is shared across heads.  On the tensor cores each such
// product takes two TF32 terms where its other operand is bf16 (exact in
// TF32) and three in float32, so bf16 runs them at 494/2 TFLOP/s on the
// H100 SXM: at the Zamba2 prefill's shape 20.17 GFLOP, 0.0817 ms, against
// 183.0 MB, 0.0546 ms at 3.35 TB/s; operations bound it.
//
// The CUDA-core body.  One block per (b, h); the TPU's sequential chunk grid
// axis becomes a loop over chunks inside the block, with the (N,P) state in
// shared memory between them.  Where the TPU wrapper copies B and C once per
// head and transposes x and y, this kernel indexes B and C by batch and reads
// x and writes y through the strides of the model's (B,T,H,P) layout.  The
// chunk's B rows (padded to N+1 floats against bank conflicts) and dt*x
// rows stay in shared memory; C rows and the decay-masked scores are taken
// R query rows at a time, so the (Q,Q) score matrix is never held (at
// Q=256, N=P=64 the whole chunk's scores would be 256 KB).  Score pairs
// above the diagonal are selected to 0 and their exp never evaluated
// (exp(cs_i - cs_j) for j > i can overflow, and inf*0 is NaN).  A short
// last chunk (T not a multiple of Q) is walked as it is, with no padding:
// its last real row ends the state, as dt=0 padding would.  The state is
// written out after the last chunk when asked for.  Every sum runs in a
// fixed order inside one block and R depends on (Q, N, P) alone, so row b
// of a batched launch is bitwise equal to a solo launch of row b.  It
// computes on the CUDA cores in float32 from shared memory, up to two
// shared loads per fused multiply-add: 7.43 ms at the Zamba2 prefill's
// shape, slower than its plain version (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;   // per block on the H100

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Shared memory of one block, in floats: the state, the chunk's B rows and
// dt*x rows, its cumulative decays and end-of-chunk weights, then R C rows
// and R rows of scores.
inline size_t smem_bytes(int Q, int N, int P, int R) {
  const size_t q = Q, n = N, p = P, r = R;
  return (n * p + q * (n + 1) + q * p + 2 * q + r * (n + 1) + r * q) * sizeof(float);
}

// The most query rows per sub-block (at most 64, at most Q) that fit.
// Depends on (Q, N, P) only, never on the batch.  0 if nothing fits.
inline int pick_rows(int Q, int N, int P) {
  for (int r = 64; r >= 1; r >>= 1) {
    const int rows = r < Q ? r : Q;
    if (smem_bytes(Q, N, P, rows) <= kMaxSmem) return rows;
  }
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, long long xsb, long long xst, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dst, long long dsh,
    const float* __restrict__ A, const T* __restrict__ Bm, long long bsb, long long bst,
    const T* __restrict__ Cm, long long csb, long long cst, T* __restrict__ y,
    long long ysb, long long yst, long long ysh, float* __restrict__ s_out, int T_len,
    int H, int P, int N, int Q, int R) {
  extern __shared__ float smem[];
  const int ldb = N + 1;
  float* sS = smem;                  // (N, P) state
  float* sB = sS + N * P;            // (Q, N+1) B rows of the chunk
  float* sX = sB + Q * ldb;          // (Q, P) dt * x rows of the chunk
  float* sCs = sX + Q * P;           // (Q,) cumulative dt*A
  float* sW = sCs + Q;               // (Q,) dt, then exp(cs_last - cs_j)
  float* sC = sW + Q;                // (R, N+1) C rows of a row sub-block
  float* sSc = sC + R * ldb;         // (R, Q) decay-masked scores

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const float a = A[h];
  const T* xb = x + b * xsb + h * xsh;
  const float* dtb = dt + b * dsb + h * dsh;
  const T* Bb = Bm + b * bsb;
  const T* Cb = Cm + b * csb;
  T* yb = y + b * ysb + h * ysh;

  for (int i = tid; i < N * P; i += kThreads) sS[i] = 0.0f;

  for (int t0 = 0; t0 < T_len; t0 += Q) {
    const int L = T_len - t0 < Q ? T_len - t0 : Q;   // a short last chunk as it is
    for (int j = tid; j < L; j += kThreads) sW[j] = dtb[(t0 + j) * dst];
    __syncthreads();   // sW is in place; the previous chunk's readers are done
    if (tid == 0) {
      float c = 0.0f;
      for (int j = 0; j < L; ++j) {
        c = __fadd_rn(c, __fmul_rn(sW[j], a));
        sCs[j] = c;
      }
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      sB[j * ldb + n] = to_f32(Bb[(t0 + j) * bst + n]);
    }
    for (int i = tid; i < L * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      sX[j * P + p] = to_f32(xb[(t0 + j) * xst + p]) * sW[j];
    }
    __syncthreads();

    for (int r0 = 0; r0 < L; r0 += R) {
      const int rows = L - r0 < R ? L - r0 : R;
      const int nkeys = r0 + rows;   // keys j <= i < r0 + rows
      for (int i = tid; i < rows * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        sC[r * ldb + n] = to_f32(Cb[(t0 + r0 + r) * cst + n]);
      }
      __syncthreads();
      // scores: (C_i . B_j) exp(cs_i - cs_j) for j <= i; 0 selected above
      for (int idx = tid; idx < rows * nkeys; idx += kThreads) {
        const int r = idx / nkeys, j = idx - r * nkeys;
        const int i = r0 + r;
        float s = 0.0f;
        if (j <= i) {
          const float* cr = sC + r * ldb;
          const float* br = sB + j * ldb;
          float dot = 0.0f;
          for (int n = 0; n < N; ++n) dot = fmaf(cr[n], br[n], dot);
          s = dot * expf(sCs[i] - sCs[j]);
        }
        sSc[r * Q + j] = s;
      }
      __syncthreads();
      // y_i = scores_i . (dt*x) + exp(cs_i) C_i . S_prev
      for (int idx = tid; idx < rows * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        const int i = r0 + r;
        const float* sr = sSc + r * Q;
        float acc = 0.0f;
        for (int j = 0; j <= i; ++j) acc = fmaf(sr[j], sX[j * P + p], acc);
        const float* cr = sC + r * ldb;
        float inter = 0.0f;
        for (int n = 0; n < N; ++n) inter = fmaf(cr[n], sS[n * P + p], inter);
        acc += inter * expf(sCs[i]);
        store(yb + (t0 + i) * yst + p, acc);
      }
      __syncthreads();   // sC and sSc are reused by the next sub-block
    }

    // S = exp(cs_last) S + sum_j exp(cs_last - cs_j) B_j (x) dt_j x_j
    const float last = sCs[L - 1];
    for (int j = tid; j < L; j += kThreads) sW[j] = expf(last - sCs[j]);
    __syncthreads();
    const float decay = expf(last);
    for (int idx = tid; idx < N * P; idx += kThreads) {
      const int n = idx / P, p = idx - n * P;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) acc = fmaf(sW[j] * sB[j * ldb + n], sX[j * P + p], acc);
      sS[idx] = sS[idx] * decay + acc;
    }
    __syncthreads();
  }

  if (s_out != nullptr) {
    float* so = s_out + static_cast<long long>(blockIdx.x) * N * P;
    for (int i = tid; i < N * P; i += kThreads) so[i] = sS[i];
  }
}

template <typename T>
int launch(const void* x, long long xsb, long long xst, long long xsh, const float* dt,
           long long dsb, long long dst, long long dsh, const float* A, const void* Bm,
           long long bsb, long long bst, const void* Cm, long long csb, long long cst,
           void* y, long long ysb, long long yst, long long ysh, float* s_out, int batch,
           int T_len, int H, int P, int N, int Q, cudaStream_t stream) {
  const int R = pick_rows(Q, N, P);
  if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q, N, P, R);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_scan_kernel<T><<<batch * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), xsb, xst, xsh, dt, dsb, dst, dsh, A,
      static_cast<const T*>(Bm), bsb, bst, static_cast<const T*>(Cm), csb, cst,
      static_cast<T*>(y), ysb, yst, ysh, s_out, T_len, H, P, N, Q, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (batch,T,H,P) with element strides (xsb, xst, xsh, 1); dt: (batch,T,H)
// with strides (dsb, dst, dsh); A: contiguous (H,); Bm, Cm: (batch,T,N) with
// strides (bsb, bst, 1) and (csb, cst, 1); y: (batch,T,H,P) with strides
// (ysb, yst, ysh, 1); s_out: contiguous (batch,H,N,P) float32, or null.
// dtype: 0 float32, 1 bfloat16 (x, Bm, Cm and y alike).  Q is the chunk
// length; a (Q, N, P) whose tiles do not fit one block's shared memory is
// refused with cudaErrorInvalidValue.  The wrapper checks shapes, types,
// devices and strides; this returns a CUDA error code.
extern "C" int ssd_scan_fwd(const void* x, long long xsb, long long xst, long long xsh,
                            const void* dt, long long dsb, long long dst, long long dsh,
                            const void* A, const void* Bm, long long bsb, long long bst,
                            const void* Cm, long long csb, long long cst, void* y,
                            long long ysb, long long yst, long long ysh, void* s_out,
                            int dtype, int batch, int T_len, int H, int P, int N, int Q,
                            void* stream) {
  if (batch == 0 || T_len == 0 || H == 0 || P == 0 || N == 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0) {
    return launch<float>(x, xsb, xst, xsh, dtf, dsb, dst, dsh, Af, Bm, bsb, bst, Cm, csb,
                         cst, y, ysb, yst, ysh, so, batch, T_len, H, P, N, Q, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, xsb, xst, xsh, dtf, dsb, dst, dsh, Af, Bm, bsb, bst,
                                 Cm, csb, cst, y, ysb, yst, ysh, so, batch, T_len, H, P,
                                 N, Q, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body (ssd_mma.cuh), arguments as ssd_scan_fwd; x, B and C
// with 16-byte aligned bases and strides (the wrapper checks).  A shape the
// body does not take (ssd_mma::fits) is refused with cudaErrorInvalidValue.
extern "C" int ssd_scan_fwd_mma(const void* x, long long xsb, long long xst, long long xsh,
                                const void* dt, long long dsb, long long dst, long long dsh,
                                const void* A, const void* Bm, long long bsb, long long bst,
                                const void* Cm, long long csb, long long cst, void* y,
                                long long ysb, long long yst, long long ysh, void* s_out,
                                int dtype, int batch, int T_len, int H, int P, int N, int Q,
                                void* stream) {
  if (batch == 0 || T_len == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0) {
    return ssd_mma::launch<float>(x, xsb, xst, xsh, dtf, dsb, dst, dsh, Af, Bm, bsb, bst, Cm,
                                  csb, cst, y, ysb, yst, ysh, so, batch, T_len, H, P, N, Q, s);
  }
  if (dtype == 1) {
    return ssd_mma::launch<__nv_bfloat16>(x, xsb, xst, xsh, dtf, dsb, dst, dsh, Af, Bm, bsb,
                                          bst, Cm, csb, cst, y, ysb, yst, ysh, so, batch, T_len,
                                          H, P, N, Q, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The longest chunk ssd_scan_fwd_mma takes at (dtype, N), 0 where it takes
// no chunk (ssd_mma::max_chunk): the table kernels/ssm_scan.py's ssd_route
// routes by, which chip_smoke.py and a gpu test compare with this.
extern "C" int ssd_scan_mma_max_chunk(int dtype, int N) {
  if (dtype != 0 && dtype != 1) return 0;
  return ssd_mma::max_chunk(dtype == 1 ? 2 : 4, N);
}

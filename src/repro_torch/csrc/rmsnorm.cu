// Rowwise RMSNorm for Hopper (sm_90a): x (rows, D) in float32 or bfloat16,
// w (D,) float32, out in x's type.
//
// Replaces the TPU kernel `rmsnorm_kernel` -> `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py (pallas_call at :29).  Same function:
// out = f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w), cast to x's type.
//
// Bound.  About 4 flops per element against reading x once and writing
// out once: memory-bound, the least time is 2 * rows * D * sizeof(x) (plus
// w) over 3.35 TB/s.  What stands between a kernel and that bound at these
// sizes (a few MB, one launch) is the number of loads in flight and the
// instructions per byte.
//
// Two bodies, picked by the caller (the wrapper) from D and the pointers:
//  * vec: D a multiple of 16 bytes' worth of elements (8 bf16, 4 float32),
//    at most 8 * 32 * 4 such vectors (D <= 8192 bf16, 4096 float32), and
//    x, w, out 16-byte aligned.  WPR = 1, 2, 4 or 8 warps per row, the
//    fewest that leave each lane at most 4 vectors (picked from D alone:
//    D = 960 bf16 one warp, 960 float32 two, 2560 bf16 four, 2560 float32
//    eight), 8 / WPR rows per 256-thread block.  Each lane issues all of
//    its 16-byte loads of the row before it uses any, so the row is in
//    flight at once and stays in registers: it is read from memory once,
//    and the sum of squares and the scale both come from registers.
//    Spreading a wide row over several warps keeps a few rows (the decode
//    step's 8) on as many SMs, where one warp per row would queue a whole
//    row's loads on one.  w comes in by 16-byte loads issued with the row's
//    (one read of w per row), so a row costs one memory round trip before
//    its store.  A warp's sum is a fixed xor-shuffle tree and the row's
//    warps are added in fixed order, so a row's result depends on that row
//    alone (batched == solo bitwise).
//  * scalar: any D and alignment (an offset view, an odd D).  One block of
//    256 threads per row, scalar strided loads, warp sums added in fixed
//    order from shared memory, and a second pass over the row (from L1/L2)
//    to scale it.
// Both compute in float32 from the same formula; they may differ from each
// other in the last bit (other summation order), never from themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVpl = 4;          // 16-byte vectors per lane on the vec body, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// vec: one warp per row, the row in registers
// ---------------------------------------------------------------------------

// The E = 16 / sizeof(T) values of a 16-byte vector, as float32.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);              // bf16 -> f32 is exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int WPR>
__global__ void __launch_bounds__(kThreads) rmsnorm_vec_kernel(const T* __restrict__ x,
                                                               const float* __restrict__ w,
                                                               T* __restrict__ out, int rows,
                                                               int D, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kRowsPerBlock = kWarps / WPR;
  __shared__ float partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % WPR;            // this warp's place among its row's warps
  const int row = blockIdx.x * kRowsPerBlock + warp / WPR;
  const bool valid = row < rows;
  const int nvec = D / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * D);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * D);

  // vectors sub*32 + lane + 32*WPR*i of the row, and the matching w
  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4 raw[kVpl];
  float4 wv[kVpl][E / 4];
#pragma unroll
  for (int i = 0; i < kVpl; ++i) {          // every load of the row (and w) before any use
    const int c = sub * 32 + lane + 32 * WPR * i;
    if (valid && c < nvec) {
      raw[i] = xr[c];
#pragma unroll
      for (int e = 0; e < E / 4; ++e) wv[i][e] = __ldg(w4 + c * (E / 4) + e);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) {
    if (valid && sub * 32 + lane + 32 * WPR * i < nvec) {
      float f[E];
      unpack(raw[i], f, T());
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, offset);
  }
  if (WPR > 1) {
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int i = 0; i < WPR; ++i) ss += partial[warp - sub + i];
  }
  if (!valid) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);

#pragma unroll
  for (int i = 0; i < kVpl; ++i) {
    const int c = sub * 32 + lane + 32 * WPR * i;
    if (c < nvec) {
      float f[E];
      unpack(raw[i], f, T());
#pragma unroll
      for (int e = 0; e < E / 4; ++e) {
        f[4 * e] = f[4 * e] * r * wv[i][e].x;
        f[4 * e + 1] = f[4 * e + 1] * r * wv[i][e].y;
        f[4 * e + 2] = f[4 * e + 2] * r * wv[i][e].z;
        f[4 * e + 3] = f[4 * e + 3] * r * wv[i][e].w;
      }
      orow[c] = pack(f, T());
    }
  }
}

template <typename T, int WPR>
int launch_vec(const void* x, const void* w, void* out, int rows, int D, float eps,
               cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  rmsnorm_vec_kernel<T, WPR><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// Warps per row from D alone: the fewest of 1, 2, 4, 8 that cover the row's
// 16-byte vectors at kVpl a lane.
template <typename T>
int dispatch_vec(const void* x, const void* w, void* out, int rows, int D, float eps,
                 cudaStream_t s) {
  const int nvec = D / (16 / static_cast<int>(sizeof(T)));
  if (nvec <= 32 * kVpl) return launch_vec<T, 1>(x, w, out, rows, D, eps, s);
  if (nvec <= 64 * kVpl) return launch_vec<T, 2>(x, w, out, rows, D, eps, s);
  if (nvec <= 128 * kVpl) return launch_vec<T, 4>(x, w, out, rows, D, eps, s);
  if (nvec <= 256 * kVpl) return launch_vec<T, 8>(x, w, out, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// scalar: one block per row, two passes
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_scalar_kernel(const T* __restrict__ x,
                                                                  const float* __restrict__ w,
                                                                  T* __restrict__ out, int D,
                                                                  float eps) {
  __shared__ float partial[kWarps];
  const int tid = threadIdx.x;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* orow = out + static_cast<size_t>(blockIdx.x) * D;

  float ss = 0.0f;
  for (int i = tid; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, offset);
  }
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += partial[i];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);

  for (int i = tid; i < D; i += kThreads) {
    store(orow + i, to_f32(xr[i]) * r * w[i]);
  }
}

template <typename T>
int launch_scalar(const void* x, const void* w, void* out, int rows, int D, float eps,
                  cudaStream_t s) {
  rmsnorm_scalar_kernel<T><<<rows, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, out: contiguous (rows, D); w: contiguous (D,) float32.  dtype: 0 float32,
// 1 bfloat16 (x and out alike).  vec: 1 for the vec body (D a multiple of 16
// bytes' worth of elements, at most 8 * 32 * 4 vectors; x, w, out 16-byte
// aligned: refused otherwise), 0 for the scalar body.  Returns a CUDA error
// code.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int rows, int D,
                           int dtype, float eps, int vec, void* stream) {
  if (rows == 0 || D == 0) return static_cast<int>(cudaSuccess);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const int per = dtype == 0 ? 4 : 8;
    if (D % per != 0 || !aligned16(x) || !aligned16(w) || !aligned16(out)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return dtype == 0 ? dispatch_vec<float>(x, w, out, rows, D, eps, s)
                      : dispatch_vec<__nv_bfloat16>(x, w, out, rows, D, eps, s);
  }
  return dtype == 0 ? launch_scalar<float>(x, w, out, rows, D, eps, s)
                    : launch_scalar<__nv_bfloat16>(x, w, out, rows, D, eps, s);
}

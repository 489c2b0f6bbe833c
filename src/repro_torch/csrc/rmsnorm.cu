// Rowwise RMSNorm for Hopper (sm_90a): x (rows, D) in float32 or bfloat16,
// w (D,) float32, out in x's type.
//
// Replaces the TPU kernel `rmsnorm_kernel` -> `_rmsnorm_kernel` in
// src/repro/kernels/rmsnorm.py (pallas_call at :29).  Same function:
// out = f32(x) * rsqrt(mean(f32(x)^2) + eps) * f32(w), cast to x's type.
//
// Design.  One block of 256 threads per row (the TPU kernel's row blocks
// become the grid).  Each thread sums the squares of its strided columns in
// float32, warps reduce with shuffles, and every thread adds the 8 warp
// partials from shared memory in the same fixed order, so a row's result
// depends on that row alone.  A second pass over the row (now in L1/L2)
// scales and writes it.
//
// Bound.  About 4 flops per element against reading x once and writing
// out once: memory-bound, the least time is 2 * rows * D * sizeof(x) (plus
// w) over 3.35 TB/s.  Scalar loads and one row per block leave some of
// that on the table at narrow D; vector loads are the later speed change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(const T* __restrict__ x,
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

}  // namespace

// x, out: contiguous (rows, D); w: contiguous (D,) float32.  dtype: 0 float32,
// 1 bfloat16 (x and out alike).  Returns a CUDA error code.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int rows, int D,
                           int dtype, float eps, void* stream) {
  if (rows == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), D, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

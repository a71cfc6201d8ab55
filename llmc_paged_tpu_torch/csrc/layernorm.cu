// LayerNorm over rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel _ln_kernel of
// llmc_paged_tpu/ops/dev/bench_layernorm.py (line 26; pallas_call at :41 in
// pallas_layernorm), entry layernorm_rows of
// llmc_paged_tpu_torch/ops/dev/bench_layernorm.py (the kernel lab).
//
// Contract: out[r, :] = (x[r, :] - mean) / sqrt(var + eps) * w + b, with the
// mean and the biased variance of row r taken in f32 in two passes, and the
// result rounded to x's dtype once. x (R, C) f32 or bf16, w and b (C,) f32,
// out (R, C) in x's dtype, all contiguous; C <= 2048.
//
// Bound on the H100: bytes, 2*R*C*itemsize + 2*C*4 at 3.35 TB/s:
// (8, 768) f32 0.015 us (the launch costs more), (8192, 768) f32 15.0 us.
//
// Design: one warp a row, 4 rows a block of 128 threads. Lane l holds the
// elements l, l+32, ... of its row in registers (C = 768: 24 a lane,
// C = 1600: 50), so the row is read once and written once: a warp sum gives
// the mean, a second one over the held values the variance, then the affine
// tail, with the products and the sum rounded one at a time as the plain
// version rounds them. Instances hold up to 8, 32 or 64 values a lane
// (C <= 256, 1024, 2048).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = THREADS / 32;   // rows a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(THREADS)
layernorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ out, int R,
                      int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= R) return;                  // no block-wide sync below
  const T* xr = x + (size_t)row * C;

  float v[VPL];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < C ? to_f32(xr[i]) : 0.f;
    s += v[k];
  }
  const float mean = warp_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const float d = lane + 32 * k < C ? v[k] - mean : 0.f;
    ss += d * d;
  }
  const float var = warp_sum(ss) / C;
  const float rstd = 1.f / sqrtf(var + eps);

  T* orow = out + (size_t)row * C;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < C) {
      const float y = __fmul_rn(__fmul_rn(v[k] - mean, rstd), w[i]);
      orow[i] = from_f32<T>(__fadd_rn(y, b[i]));
    }
  }
}

template <typename T, int VPL>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int R, int C, float eps, cudaStream_t stream) {
  layernorm_rows_kernel<T, VPL><<<(R + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), R, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* x, const void* w, const void* b, void* out,
                     int R, int C, float eps, cudaStream_t s) {
  if (R < 1 || C < 1) return cudaErrorInvalidValue;
  if (C <= 8 * 32) return launch<T, 8>(x, w, b, out, R, C, eps, s);
  if (C <= 32 * 32) return launch<T, 32>(x, w, b, out, R, C, eps, s);
  if (C <= 64 * 32) return launch<T, 64>(x, w, b, out, R, C, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/dev/bench_layernorm.py).
enum { KIND_F32 = 0, KIND_BF16 = 1 };

// x_kind: KIND_F32 | KIND_BF16 (out has x's kind). Returns
// cudaGetLastError() after the launch; an unsupported kind or C > 2048
// returns cudaErrorInvalidValue without launching.
extern "C" int layernorm_rows(int x_kind, const void* x, const void* w,
                              const void* b, void* out, int R, int C,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == KIND_F32)
    return static_cast<int>(launch_c<float>(x, w, b, out, R, C, eps, s));
  if (x_kind == KIND_BF16)
    return static_cast<int>(
        launch_c<__nv_bfloat16>(x, w, b, out, R, C, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Softmax over whole vocab rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel _softmax_kernel of
// llmc_paged_tpu/ops/dev/bench_softmax.py (line 27; pallas_call at :40 in
// pallas_softmax_rows), entry softmax_rows of
// llmc_paged_tpu_torch/ops/dev/bench_softmax.py (the kernel lab).
//
// Contract: out[b, :] = exp(x[b, :] - m) / sum exp(x[b, :] - m), m the row's
// max, computed in f32 and rounded to x's dtype once. x (B, V) f32 or bf16,
// out (B, V) in x's dtype, contiguous; V * 4 bytes (plus 128) within the
// 227 KB of shared memory a block may opt in to (V <= 58,080).
//
// Bound on the H100: bytes, 2*B*V*itemsize at 3.35 TB/s: (8, 50304) f32
// 0.96 us.
//
// Design: one block of 1024 threads a row. The row is read once into dynamic
// shared memory as f32 (V*4 bytes: 201 KB at V = 50304, above the 48 KB
// default, so the launch opts in with cudaFuncSetAttribute), each thread
// keeping the max of its ~50 values; a block max (warp shuffles, then one warp
// over the 32 partials); exp(x - m) in place, each thread summing its own; a
// block sum; then the row is written once, e / sum. Every thread touches the
// same columns in every pass, so only the reductions synchronize. Only B of
// the 132 SMs work: at B = 8 the kernel sits far above its bound (splitting a
// row over a thread-block cluster is later work).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;          // Hopper's opt-in limit a block
constexpr size_t STATIC_SMEM = WARPS * sizeof(float);

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide max (MAX) or sum of v, returned to every thread; red holds
// WARPS floats and is free again on return
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];                     // WARPS == 32: a lane a partial
    v = MAX ? warp_max(v) : warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int V) {
  extern __shared__ float row[];       // V floats
  __shared__ float red[WARPS];
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * V;

  float m = -INFINITY;
  for (int i = tid; i < V; i += THREADS) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, red);

  float s = 0.f;
  for (int i = tid; i < V; i += THREADS) {
    const float e = expf(row[i] - m);
    row[i] = e;
    s += e;
  }
  s = block_reduce<false>(s, red);

  T* orow = out + (size_t)blockIdx.x * V;
  for (int i = tid; i < V; i += THREADS) orow[i] = from_f32<T>(row[i] / s);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int V,
                   cudaStream_t stream) {
  const size_t smem = (size_t)V * sizeof(float);
  if (B < 1 || V < 1 || smem + STATIC_SMEM > MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = softmax_rows_kernel<T>;
  if (smem > DEFAULT_SMEM - STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<B, THREADS, smem, stream>>>(static_cast<const T*>(x),
                                     static_cast<T*>(out), V);
  return cudaGetLastError();
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/dev/bench_softmax.py).
enum { KIND_F32 = 0, KIND_BF16 = 1 };

// x_kind: KIND_F32 | KIND_BF16 (out has x's kind). Returns
// cudaGetLastError() after the launch; an unsupported kind, or a row too
// wide for shared memory, returns cudaErrorInvalidValue without launching.
extern "C" int softmax_rows(int x_kind, const void* x, void* out, int B,
                            int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == KIND_F32)
    return static_cast<int>(launch<float>(x, out, B, V, s));
  if (x_kind == KIND_BF16)
    return static_cast<int>(launch<__nv_bfloat16>(x, out, B, V, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

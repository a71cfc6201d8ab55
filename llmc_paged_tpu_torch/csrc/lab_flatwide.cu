// "Flatwide" paged-attention parts, for Hopper (sm_90a): the kernel lab's
// record of the design with no online rescaling.
//
// Replaces the TPU kernel _make_flash_decode_flatwide_kernel(B, W, quant) of
// llmc_paged_tpu/ops/dev/lab_flatwide.py (line 57; pallas_call at :197 in
// _flatwide_parts_call, :159), entry flatwide_parts of
// llmc_paged_tpu_torch/ops/dev/lab_flatwide.py. float, bf16 and int8 pools.
//
// Contract: the parts contract of csrc/paged_attention.cu. For each row b
// and head h, single-query attention over the tokens [start, len) read
// through the block table, scores multiplied by rsqrt(HS) and (int8) then by
// the token's K scale, UNNORMALIZED outputs acc (B, NH, HS), m (B, NH) and
// l (B, NH), all f32; l sums p BEFORE the int8 V scale multiplies p; a row
// with no live token gives m = NEG_INF (-1e30), l = 0, acc = 0. Layout:
// q (B, NH, HS) f32/bf16, pages (P, NH, HS, ps) token-minor, scales
// (P, NH, ps); HS = 64.
//
// What the TPU kernel did, and what is not carried over: it DMA'd every live
// page of the whole batch into one wide VMEM buffer, scored every row against
// every other row's columns and masked them away (B times the work), and
// capped the buffer at 4096 lanes with ps % 128 == 0 (VMEM). What is kept is
// its idea: no online rescaling, one max, one exp pass, one sum.
//
// Design: grid (B, NH), 128 threads, three passes over the row's live
// tokens:
//   1. a thread a token writes its score q.K[:, t] into a shared array of
//      pps*ps floats (K read along d; neighbouring threads on neighbouring
//      tokens, so neighbouring addresses) and keeps its running max;
//   2. one block max m; p = exp(s - m) in place; l = the block sum of p;
//      then p *= v_scale (int8);
//   3. acc = sum_t p_t V[:, t]: the warps split the tokens in 32-token
//      chunks, a lane a token keeping acc[HS] in registers; each warp reduces
//      its lanes with shuffles and the warps merge through shared memory.
// A row whose live range is empty keeps m = NEG_INF (the max's start value)
// and sums nothing. Shared memory: 4*(pps*ps + HS + WARPS*HS + WARPS) bytes,
// opted in above 48 KB; the wrapper raises above 227 KB (pps*ps up to about
// 57,800 tokens). Any page size works: the TPU's ps % 128 rule was Mosaic's.
//
// Bound on the H100: the parts kernel's, bytes: K/V (and int8 scales) of the
// live tokens, in the 32-byte sectors that hold them, at 3.35 TB/s. Plain
// loads, no cp.async/TMA: a first kernel that is right.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

// block-wide max (MAX) or sum, returned to every thread; red (WARPS floats)
// is free again on return
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

size_t smem_bytes(int HS, int ps, int pps) {
  return sizeof(float) * ((size_t)pps * ps + HS + (size_t)WARPS * HS + WARPS);
}

template <typename QT, typename KV, bool QUANT, int HS>
__global__ void __launch_bounds__(THREADS)
flatwide_parts_kernel(const QT* __restrict__ q, const KV* __restrict__ k_pages,
                      const KV* __restrict__ v_pages,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tables,
                      const int* __restrict__ lengths,
                      const int* __restrict__ starts,
                      float* __restrict__ acc_out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int NH, int ps, int pps,
                      float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // HS
  float* acc_s = q_s + HS;               // WARPS * HS
  float* red = acc_s + WARPS * HS;       // WARPS
  float* p_s = red + WARPS;              // pps * ps: scores, then p

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = max(starts[b], 0);
  const int hi = min(lengths[b], pps * ps);
  const int n = max(hi - lo, 0);         // live tokens
  const int* trow = tables + (size_t)b * pps;
  const size_t row = (size_t)b * NH + h;

  for (int d = tid; d < HS; d += THREADS) q_s[d] = to_f32(q[row * HS + d]);
  __syncthreads();

  // 1: every live token's score
  float mloc = NEG_INF;
  for (int i = tid; i < n; i += THREADS) {
    const int pos = lo + i;
    const size_t head = (size_t)trow[pos / ps] * NH + h;
    const int t = pos % ps;
    const KV* kp = k_pages + head * HS * ps + t;
    float dot = 0.f;
#pragma unroll 16
    for (int d = 0; d < HS; ++d) dot += q_s[d] * to_f32(kp[(size_t)d * ps]);
    float s = dot * scale;
    if (QUANT) s = s * k_scale[head * ps + t];
    p_s[i] = s;
    mloc = fmaxf(mloc, s);
  }

  // 2: one max, p in place, l before the V scale
  const float m = block_reduce<true>(mloc, red);
  float lloc = 0.f;
  for (int i = tid; i < n; i += THREADS) {
    float p = expf(p_s[i] - m);
    lloc += p;
    if (QUANT) {
      const int pos = lo + i;
      p = p * v_scale[((size_t)trow[pos / ps] * NH + h) * ps + pos % ps];
    }
    p_s[i] = p;
  }
  const float l = block_reduce<false>(lloc, red);   // p_s complete after it

  // 3: acc, a lane a token, the warps on alternate 32-token chunks
  float acc[HS];
#pragma unroll
  for (int d = 0; d < HS; ++d) acc[d] = 0.f;
  for (int c = warp * 32; c < n; c += WARPS * 32) {
    const int i = c + lane;
    if (i < n) {
      const int pos = lo + i;
      const KV* vp = v_pages + ((size_t)trow[pos / ps] * NH + h) * HS * ps +
                     pos % ps;
      const float p = p_s[i];
#pragma unroll
      for (int d = 0; d < HS; ++d) acc[d] += p * to_f32(vp[(size_t)d * ps]);
    }
  }
#pragma unroll
  for (int d = 0; d < HS; ++d) {
    const float a = warp_sum(acc[d]);
    if (lane == 0) acc_s[warp * HS + d] = a;
  }
  __syncthreads();
  for (int d = tid; d < HS; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += acc_s[w * HS + d];
    acc_out[row * HS + d] = a;
  }
  if (tid == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename QT, typename KV, bool QUANT>
cudaError_t launch(int HS, const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, const void* starts, void* acc,
                   void* m, void* l, int B, int NH, int ps, int pps,
                   float scale, cudaStream_t stream) {
  // acc[HS] is a register tile: one instance, head size 64 (every GPT-2
  // size's)
  if (HS != 64 || B < 1 || NH < 1 || ps < 1 || pps < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(HS, ps, pps);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = flatwide_parts_kernel<QT, KV, QUANT, 64>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, NH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), NH, ps, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/paged_attention.py's
// enum, which ops/dev/lab_flatwide.py uses).
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). HS: 64. Returns cudaGetLastError()
// after the launch; an unsupported kind, head size or shared-memory size
// returns cudaErrorInvalidValue without launching.
extern "C" int flatwide_parts(int q_kind, int kv_kind, const void* q,
                              const void* k, const void* v, const void* ks,
                              const void* vs, const void* tables,
                              const void* lengths, const void* starts,
                              void* acc, void* m, void* l, int B, int NH,
                              int HS, int ps, int pps, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(QTY, KV, QUANT)                                             \
  return static_cast<int>(launch<QTY, KV, QUANT>(                         \
      HS, q, k, v, ks, vs, tables, lengths, starts, acc, m, l, B, NH, ps,  \
      pps, scale, s))
  if (q_kind == KIND_F32) {
    if (kv_kind == KIND_F32) LAUNCH(float, float, false);
    if (kv_kind == KIND_BF16) LAUNCH(float, __nv_bfloat16, false);
    if (kv_kind == KIND_I8) LAUNCH(float, int8_t, true);
  } else if (q_kind == KIND_BF16) {
    if (kv_kind == KIND_F32) LAUNCH(__nv_bfloat16, float, false);
    if (kv_kind == KIND_BF16) LAUNCH(__nv_bfloat16, __nv_bfloat16, false);
    if (kv_kind == KIND_I8) LAUNCH(__nv_bfloat16, int8_t, true);
  }
#undef LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash-decode "parts" over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernels of llmc_paged_tpu/ops/paged_attention.py:
//   * _make_flash_decode_flat_kernel(B, quant=False)   (float/bf16 pools)
//   * _make_flash_decode_flat_kernel(B, quant=True), pinned-scale and
//     scale_dma variants                                 (int8 pools)
//   * _make_flash_decode_gridb_kernel(quant)             (B*pps > 4096)
// One kernel covers all of them: there is no page-size floor (the TPU's
// ps % 128 DMA rule) and no schedule cap (the TPU's SMEM B*pps limit).
//
// Contract (the JAX package's parts contract): for each row b and head h,
// single-query attention over the row's live pages
// [start/ps, (len-1)/ps] read through the block table, positions outside
// [start, len) masked, f32 online softmax, UNNORMALIZED outputs
//   acc (B, NH, HS) f32, m (B, NH) f32, l (B, NH) f32.
// NEG_INF is -1e30 (never -inf); a lane whose score is <= NEG_INF/2 gets
// p = 0; l sums p BEFORE the int8 V scale multiplies p; a row with length
// 0, or fully masked, gives m = NEG_INF, l = 0, acc = 0. For int8 pools
// the per-(page, head, token) f32 scales fold in after the dots: scores
// are multiplied by ks per token, p by vs per token.
//
// Layout: pages are (P, NH, HS, ps) (token-minor), scales (P, NH, ps).
//
// Design: grid (B, NH), 128 threads. Per live page, thread t scores the
// tokens t, t+128, ... by reading K[page, h, d, t] over d, so neighbouring
// threads read neighbouring addresses. A block reduction gives the page
// max, then p and its sum; the PV product is a warp reduction over the
// page's tokens for each d (warp w owns d = w, w+4, ...), again with
// neighbouring lanes on neighbouring addresses.
//
// Bound on the H100: bytes. At the GPT-2 124M serving shapes (B=8, NH=12,
// HS=64, ps=128, int8 pool) one call reads 8-16 live pages of 208,896 B
// (int8 K and V plus their f32 scales): 1.7-3.3 MB, 0.5-1 us at
// 3.35 TB/s, so a call is bound by its launch cost, not its bytes. The
// kernel issues plain loads with no cp.async/TMA pipeline and one block
// per (row, head); split-K over pages, TMA staging and fusing the layer
// loop are left to later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

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

// Block-wide max / sum; every thread receives the result. `red` holds
// WARPS floats; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

template <typename QT, typename KV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_parts_kernel(const QT* __restrict__ q,
                          const KV* __restrict__ k_pages,
                          const KV* __restrict__ v_pages,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          const int* __restrict__ starts,
                          float* __restrict__ acc_out,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out,
                          int NH, int HS, int ps, int pps, float scale) {
  // dynamic shared memory: q (HS) | acc (HS) | p (ps) | red (WARPS)
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + HS;
  float* p_s = acc_s + HS;
  float* red = p_s + ps;

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int start = starts[b];
  const int first = start / ps;
  const int last = length > 0 ? (length - 1) / ps : -1;
  const int num = max(last - first + 1, 0);

  const QT* qrow = q + ((size_t)b * NH + h) * HS;
  for (int d = tid; d < HS; d += THREADS) {
    q_s[d] = to_f32(qrow[d]);
    acc_s[d] = 0.f;
  }
  __syncthreads();

  float m = NEG_INF, l = 0.f;
  for (int i = 0; i < num; ++i) {
    const int pidx = first + i;
    const int page = tables[(size_t)b * pps + pidx];
    const size_t head = (size_t)page * NH + h;
    const KV* kp = k_pages + head * HS * ps;
    const KV* vp = v_pages + head * HS * ps;
    const float* ksc = QUANT ? k_scale + head * ps : nullptr;
    const float* vsc = QUANT ? v_scale + head * ps : nullptr;

    // 1-3: scores for this page, scaled, masked
    float mloc = NEG_INF;
    for (int t = tid; t < ps; t += THREADS) {
      float s = 0.f;
      for (int d = 0; d < HS; ++d) s += q_s[d] * to_f32(kp[(size_t)d * ps + t]);
      s = s * scale;
      if (QUANT) s = s * ksc[t];
      const int pos = pidx * ps + t;
      if (!(pos < length && pos >= start)) s = NEG_INF;
      p_s[t] = s;
      mloc = fmaxf(mloc, s);
    }
    // 4: page max and the online-softmax update
    const float m_new = fmaxf(m, block_max(mloc, red));
    float lloc = 0.f;
    for (int t = tid; t < ps; t += THREADS) {
      const float s = p_s[t];
      float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
      lloc += p;                        // l takes p before the V scale
      if (QUANT) p = p * vsc[t];
      p_s[t] = p;
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + block_sum(lloc, red);   // its barrier publishes p_s
    m = m_new;

    // 5: PV, a warp reduction over the page's tokens for each d
    for (int d = warp; d < HS; d += WARPS) {
      const KV* vrow = vp + (size_t)d * ps;
      float part = 0.f;
      for (int t = lane; t < ps; t += 32) part += p_s[t] * to_f32(vrow[t]);
      part = warp_sum(part);
      if (lane == 0) acc_s[d] = acc_s[d] * alpha + part;
    }
    __syncthreads();                    // p_s is rewritten by the next page
  }

  float* arow = acc_out + ((size_t)b * NH + h) * HS;
  for (int d = tid; d < HS; d += THREADS) arow[d] = acc_s[d];
  if (tid == 0) {
    m_out[(size_t)b * NH + h] = m;
    l_out[(size_t)b * NH + h] = l;
  }
}

template <typename QT, typename KV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, const void* starts, void* acc,
                   void* m, void* l, int B, int NH, int HS, int ps, int pps,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * HS + ps + WARPS);
  dim3 grid(B, NH);
  flash_decode_parts_kernel<QT, KV, QUANT><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), NH, HS, ps, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/paged_attention.py).
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). Returns cudaGetLastError() after
// the launch; an unsupported kind returns cudaErrorInvalidValue without
// launching.
extern "C" int flash_decode_parts(int q_kind, int kv_kind, const void* q,
                                  const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* tables, const void* lengths,
                                  const void* starts, void* acc, void* m,
                                  void* l, int B, int NH, int HS, int ps,
                                  int pps, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(QT, KV, QUANT)                                              \
  return static_cast<int>(launch<QT, KV, QUANT>(                          \
      q, k, v, ks, vs, tables, lengths, starts, acc, m, l, B, NH, HS, ps,  \
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

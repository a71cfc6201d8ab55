// NORMALIZED single-query paged attention over a paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of llmc_paged_tpu/ops/paged_attention.py:
//   * _make_paged_decode_grid_kernel(quant)  (entries
//     paged_decode_attention_grid and paged_decode_attention_quant_grid):
//     the kernel behind the normalized wrappers whenever the page size is
//     not a multiple of 128 (the JAX CLI's default is 32), so it serves
//     every host-sampled decode step at those page sizes.
//
// Contract (the TPU kernel's): for each row b and head h, single-query
// attention over the row's pages read through the block table, positions
// outside [start, len) masked, f32 online softmax, output NORMALIZED and
// converted to q's dtype:
//   out (B, NH, HS) = acc / l, or zeros where l == 0.
// NEG_INF is -1e30 (never -inf); a lane whose score is <= NEG_INF/2 gets
// p = 0, so a fully masked page adds nothing and a row with start >= len
// gives zeros. For int8 pools the per-(page, head, token) f32 scales
// multiply K and V BEFORE the dots, as the TPU kernel dequantizes its page
// blocks (the parts kernels fold them in afterwards).
//
// Layout: pages are (P, NH, HS, ps) (token-minor), scales (P, NH, ps).
//
// Design: the TPU walks a sequential grid of (B, pages_per_seq) steps, one
// page a step, carrying m/l/acc in scratch memory, and fetches every table
// entry, dead pages included. Here the grid is (B, NH) and the block's
// WARPS warps split the row's LIVE pages [start/ps, (len-1)/ps] among
// them: warp w takes pages w, w+WARPS, ... A lane holds one token of a
// 32-token chunk of the page (ps <= 32: one chunk; larger pages loop), so
// its loads of K[d][t] and V[d][t] over d are neighbouring addresses
// across the warp. Each lane keeps its own acc[HS] in registers and its
// own l; m is warp-uniform (a warp max per chunk), so alpha rescales every
// lane alike. At the end each warp reduces l and acc over its lanes, and
// the warps merge their (m, l, acc) through shared memory.
//
// Bound on the H100: bytes. At the CLI's shape (B=8, NH=12, HS=64, ps=32,
// lengths 65-128, f32 pool) one call reads about 5 MB of K/V: ~1.5 us at
// 3.35 TB/s, so a call is bound by its launch and its dependent per-chunk
// reductions. Plain loads, no cp.async/TMA: a first kernel that is right.

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

template <typename QT, typename KV, bool QUANT, int HS>
__global__ void __launch_bounds__(THREADS)
paged_decode_grid_kernel(const QT* __restrict__ q,
                         const KV* __restrict__ k_pages,
                         const KV* __restrict__ v_pages,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths,
                         const int* __restrict__ starts,
                         QT* __restrict__ out, int NH, int ps, int pps,
                         float scale) {
  __shared__ float q_s[HS];
  __shared__ float acc_s[WARPS][HS];
  __shared__ float m_s[WARPS], l_s[WARPS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int start = starts[b];
  const int first = start / ps;
  const int last = length > 0 ? min((length - 1) / ps, pps - 1) : -1;
  const int num = max(last - first + 1, 0);

  const size_t row = (size_t)b * NH + h;
  for (int d = tid; d < HS; d += THREADS) q_s[d] = to_f32(q[row * HS + d]);
  __syncthreads();

  float m = NEG_INF, l = 0.f;   // m is warp-uniform, l this lane's share
  float acc[HS];
#pragma unroll
  for (int d = 0; d < HS; ++d) acc[d] = 0.f;

  for (int i = warp; i < num; i += WARPS) {
    const int pidx = first + i;
    const int page = tables[(size_t)b * pps + pidx];
    const size_t head = (size_t)page * NH + h;
    const KV* kp = k_pages + head * HS * ps;
    const KV* vp = v_pages + head * HS * ps;
    for (int c = 0; c < ps; c += 32) {
      const int t = c + lane;
      const int pos = pidx * ps + t;
      const bool valid = t < ps && pos < length && pos >= start;
      float s = NEG_INF;
      float vsc = 1.f;
      if (valid) {
        const float ksc = QUANT ? k_scale[head * ps + t] : 1.f;
        if (QUANT) vsc = v_scale[head * ps + t];
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HS; ++d) {
          float kv = to_f32(kp[(size_t)d * ps + t]);
          if (QUANT) kv = kv * ksc;       // dequantize before the dot
          dot += q_s[d] * kv;
        }
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + p;
      if (valid) {
#pragma unroll
        for (int d = 0; d < HS; ++d) {
          float vv = to_f32(vp[(size_t)d * ps + t]);
          if (QUANT) vv = vv * vsc;
          acc[d] = acc[d] * alpha + p * vv;
        }
      } else {
#pragma unroll
        for (int d = 0; d < HS; ++d) acc[d] = acc[d] * alpha;
      }
      m = m_new;
    }
  }

  // each warp's (m, l, acc) over its lanes, then the merge across warps
  const float lw = warp_sum(l);
#pragma unroll
  for (int d = 0; d < HS; ++d) {
    const float a = warp_sum(acc[d]);
    if (lane == 0) acc_s[warp][d] = a;
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = lw;
  }
  __syncthreads();

  float mx = m_s[0];
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_s[w]);
  float alpha_w[WARPS];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    alpha_w[w] = expf(m_s[w] - mx);
    L += alpha_w[w] * l_s[w];
  }
  if (L == 0.f) L = 1.f;   // a fully masked row: acc is 0 -> zeros
  for (int d = tid; d < HS; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += alpha_w[w] * acc_s[w][d];
    out[row * HS + d] = from_f32<QT>(a / L);
  }
}

template <typename QT, typename KV, bool QUANT, int HS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, const void* starts, void* out, int B,
                   int NH, int ps, int pps, float scale,
                   cudaStream_t stream) {
  dim3 grid(B, NH);
  paged_decode_grid_kernel<QT, KV, QUANT, HS><<<grid, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<QT*>(out), NH, ps, pps, scale);
  return cudaGetLastError();
}

template <typename QT, typename KV, bool QUANT>
cudaError_t launch_hs(int HS, const void* q, const void* k, const void* v,
                      const void* ks, const void* vs, const void* tables,
                      const void* lengths, const void* starts, void* out,
                      int B, int NH, int ps, int pps, float scale,
                      cudaStream_t s) {
  // one instance per head size: acc[HS] is a register tile. 64 is every
  // GPT-2 size's (124M to 1.5B); another size is one more case here.
  switch (HS) {
    case 64:
      return launch<QT, KV, QUANT, 64>(q, k, v, ks, vs, tables, lengths,
                                       starts, out, B, NH, ps, pps, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/paged_attention.py).
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

// q_kind: KIND_F32 | KIND_BF16 (out has q's kind). kv_kind: KIND_F32 |
// KIND_BF16 (ks/vs ignored) | KIND_I8 (ks/vs required). HS: 64. Returns cudaGetLastError() after the launch; an unsupported kind or
// head size returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_grid(int q_kind, int kv_kind, const void* q,
                                 const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* tables, const void* lengths,
                                 const void* starts, void* out, int B,
                                 int NH, int HS, int ps, int pps, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(QT, KV, QUANT)                                              \
  return static_cast<int>(launch_hs<QT, KV, QUANT>(                       \
      HS, q, k, v, ks, vs, tables, lengths, starts, out, B, NH, ps, pps,   \
      scale, s))
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

// NORMALIZED single-query paged attention over ONE layer plane of a stacked
// (L, P, NH, HS, ps) KV pool, for Hopper (sm_90a). A kernel-lab artifact
// (ops/dev/lab_full_pool.py).
//
// Replaces the TPU kernels of llmc_paged_tpu/ops/dev/lab_full_pool.py:
//   * _paged_decode_full_kernel        (entry paged_decode_attention_full)
//   * _paged_decode_quant_full_kernel  (entry paged_decode_attention_quant_full)
// one source, with f32/bf16 q over f32, bf16 and int8 pools.
//
// Contract (the TPU kernels'): for each row b and head h, single-query
// attention over the row's pages of plane `layer`, read through the block
// table, positions outside [start, len) masked, f32 online softmax, output
// NORMALIZED and in q's dtype:
//   out (B, NH, HS) = acc / l, or zeros where l == 0.
// NEG_INF is -1e30; a lane whose score is <= NEG_INF/2 gets p = 0. For int8
// pools the (L, P, NH, ps) f32 scales multiply K and V BEFORE the dots. The
// arithmetic is that of the normalized grid kernel (paged_attention_grid.cu):
// the TPU full-pool and grid kernels share it.
//
// The layer index lives in device memory. The TPU kernels took it as a
// scalar prefetch that picked the plane in the BlockSpec index map; here the
// kernel reads layer[0] itself, so a layer loop over a stacked pool needs no
// host-known index (the wrapper never copies it to the host). A host int may
// be passed instead (layer == nullptr). The layer is clamped to [0, L), as
// jax.lax.dynamic_index_in_dim clamps.
//
// Offsets are 64-bit: plane * P * NH * HS * ps passes 2^31 elements at the
// 1.5B depth (48 x 224 x 25 x 64 x 128 = 2.2e9 int8 elements at P = 224).
//
// Design (the grid kernel's, over a plane base): grid (B, NH); the block's
// WARPS warps split the row's LIVE pages [start/ps, (len-1)/ps] (no other
// table entry is read: past the live range an entry may hold anything,
// including the drop sentinel P; a live entry is clamped to [0, P) so a bad
// one cannot read outside the pool); a lane holds one token of a 32-token
// chunk, acc[HS] in registers; a per-warp online softmax, merged across the
// warps in shared memory. start >= len reads nothing and gives zeros. The
// TPU grid walked every table entry in order, one page a step; blocks here
// run in no order, so nothing carries between them.
//
// Bound on the H100: bytes (the K/V and scales of the valid tokens). At the
// 124M decode shape (B=8, NH=12, ps=128, lengths <= 384) that is ~3 MB
// (f32) or ~1 MB (int8): 1-3 us at 3.35 TB/s, so a call is bound by its
// launch and its dependent per-chunk reductions. Plain loads, no
// cp.async/TMA: a first kernel that is right.

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
paged_decode_full_kernel(const QT* __restrict__ q,
                         const KV* __restrict__ k_pool,
                         const KV* __restrict__ v_pool,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ layer_ptr, int layer_host,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths,
                         const int* __restrict__ starts,
                         QT* __restrict__ out, int L, int P, int NH, int ps,
                         int pps, float scale) {
  __shared__ float q_s[HS];
  __shared__ float acc_s[WARPS][HS];
  __shared__ float m_s[WARPS], l_s[WARPS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int layer = min(max(layer_ptr ? layer_ptr[0] : layer_host, 0), L - 1);
  const size_t plane = static_cast<size_t>(layer) * P;  // pages before it
  const int length = lengths[b];
  const int start = starts[b];
  const int first = start / ps;
  const int last = length > 0 ? min((length - 1) / ps, pps - 1) : -1;
  const int num = start < length ? max(last - first + 1, 0) : 0;

  const size_t row = static_cast<size_t>(b) * NH + h;
  for (int d = tid; d < HS; d += THREADS) q_s[d] = to_f32(q[row * HS + d]);
  __syncthreads();

  float m = NEG_INF, l = 0.f;   // m is warp-uniform, l this lane's share
  float acc[HS];
#pragma unroll
  for (int d = 0; d < HS; ++d) acc[d] = 0.f;

  for (int i = warp; i < num; i += WARPS) {
    const int pidx = first + i;
    const int page = min(max(tables[static_cast<size_t>(b) * pps + pidx], 0),
                         P - 1);
    const size_t head = (plane + page) * NH + h;        // (layer, page, h)
    const KV* kp = k_pool + head * HS * ps;
    const KV* vp = v_pool + head * HS * ps;
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
          float kv = to_f32(kp[static_cast<size_t>(d) * ps + t]);
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
          float vv = to_f32(vp[static_cast<size_t>(d) * ps + t]);
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
  float Lsum = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    alpha_w[w] = expf(m_s[w] - mx);
    Lsum += alpha_w[w] * l_s[w];
  }
  if (Lsum == 0.f) Lsum = 1.f;   // a fully masked row: acc is 0 -> zeros
  for (int d = tid; d < HS; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += alpha_w[w] * acc_s[w][d];
    out[row * HS + d] = from_f32<QT>(a / Lsum);
  }
}

template <typename QT, typename KV, bool QUANT>
cudaError_t launch(int HS, const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* layer,
                   int layer_host, const void* tables, const void* lengths,
                   const void* starts, void* out, int B, int L, int P, int NH,
                   int ps, int pps, float scale, cudaStream_t stream) {
  // one instance per head size: acc[HS] is a register tile. 64 is every
  // GPT-2 size's (124M to 1.5B); another size is one more case here.
  if (HS != 64) return cudaErrorInvalidValue;
  dim3 grid(B, NH);
  paged_decode_full_kernel<QT, KV, QUANT, 64><<<grid, THREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(layer),
      layer_host, static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<QT*>(out), L, P, NH, ps, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/paged_attention.py).
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

// q_kind: KIND_F32 | KIND_BF16 (out has q's kind). kv_kind: KIND_F32 |
// KIND_BF16 (ks/vs ignored) | KIND_I8 (ks/vs required). layer: a device
// int32 read by the kernel, or nullptr to use layer_host. HS: 64. Returns
// cudaGetLastError() after the launch; an unsupported kind or head size
// returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_full(int q_kind, int kv_kind, const void* q,
                                 const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* layer, int layer_host,
                                 const void* tables, const void* lengths,
                                 const void* starts, void* out, int B, int L,
                                 int P, int NH, int HS, int ps, int pps,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(QT, KV, QUANT)                                               \
  return static_cast<int>(launch<QT, KV, QUANT>(                           \
      HS, q, k, v, ks, vs, layer, layer_host, tables, lengths, starts, out, \
      B, L, P, NH, ps, pps, scale, s))
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

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
// NORMALIZED and in q's dtype, rounded once:
//   out (B, NH, HS) = acc / l, or zeros where l == 0 (no live token,
//   including start >= len).
// NEG_INF is -1e30; a lane whose score is <= NEG_INF/2 gets p = 0. For int8
// pools the (L, P, NH, ps) f32 scales multiply K and V BEFORE the dots.
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
// Bound on the H100: bytes (the K/V and scales of the live tokens). At the
// 124M decode shape (B=8, NH=12, ps=128, lengths <= 384) that is ~3 MB
// (f32) or ~1 MB (int8): 1-3 us at 3.35 TB/s, so a call is bound by its
// launch and its dependent loads (layer -> length -> table entry -> K/V).
//
// Design: two paths, chosen from the shape and the pointers, never by a
// failure:
//   * ps % 4 == 0 and pools (and int8 scales) aligned to a 4-element vector:
//     the parts template's PLANE instance (paged_attention_parts.cuh,
//     QTILE = 1, NORM, 8 warps), the normalized grid kernel's design over a
//     plane base: the warps split the row's live range in 32-token chunks
//     across pages, a lane loads 4 tokens x 16 head dims of K and V as
//     vectors, int8 converts by byte permutes, one merge divides by l. The
//     plane flavour adds the layer read and clamp, the 64-bit plane base,
//     a clamp of each live table entry to [0, P), and the int8 scales
//     applied to K and V before the dots.
//   * any other page size or alignment: full_scalar_kernel below (the first
//     design): grid (B, NH); 4 warps take the row's live pages in turn (only
//     live entries are read, each clamped to [0, P)); a lane holds one token
//     of a 32-token chunk, acc[HS] in registers, scalar loads; a per-warp
//     online softmax merged across the warps in shared memory.

#include "paged_attention_parts.cuh"

namespace {

using parts::NEG_INF;
using parts::to_f32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename QT, typename KV, bool QUANT, int HS>
__global__ void __launch_bounds__(THREADS)
full_scalar_kernel(const QT* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ layer_ptr, int layer_host,
                   const int* __restrict__ tables,
                   const int* __restrict__ lengths,
                   const int* __restrict__ starts, QT* __restrict__ out,
                   int L, int P, int NH, int ps, int pps, float scale) {
  __shared__ float q_s[HS];
  __shared__ float acc_s[WARPS][HS];
  __shared__ float m_s[WARPS], l_s[WARPS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int layer = min(max(layer_ptr ? layer_ptr[0] : layer_host, 0), L - 1);
  const size_t plane = static_cast<size_t>(layer) * P;  // pages before it
  const int length = lengths[b];
  const int start = max(starts[b], 0);   // a negative start reads from 0
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
      const float m_new = fmaxf(m, parts::warp_max(s));
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
  const float lw = parts::warp_sum(l);
#pragma unroll
  for (int d = 0; d < HS; ++d) {
    const float a = parts::warp_sum(acc[d]);
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
    parts::store(out + row * HS + d, a / Lsum);
  }
}

}  // namespace

// Element kinds: parts::KIND_*, shared with the Python wrapper
// (ops/paged_attention.py). q_kind: KIND_F32 | KIND_BF16 (out has q's kind). kv_kind: KIND_F32 |
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
  if (parts::vector_path(kv_kind, k, v, ks, vs, ps))
    return parts::launch<1, true, true>(
        q_kind, kv_kind, q, k, v, ks, vs, tables, lengths, starts, out,
        nullptr, nullptr, B, 1, NH, HS, ps, pps, scale, stream,
        parts::Plane{static_cast<const int*>(layer), layer_host, L, P});
  // acc[HS] is a register tile: one instance, 64 (every GPT-2 size's)
  if (HS != 64 || ps < 1 || B < 1 || NH < 1 || pps < 1 || L < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return parts::dispatch_kinds(q_kind, kv_kind, [&](auto qt, auto kv,
                                                    auto quant) {
    using QT = typename decltype(qt)::type;
    using KV = typename decltype(kv)::type;
    full_scalar_kernel<QT, KV, decltype(quant)::value, 64>
        <<<dim3(B, NH), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const QT*>(q), static_cast<const KV*>(k),
            static_cast<const KV*>(v), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int*>(layer),
            layer_host, static_cast<const int*>(tables),
            static_cast<const int*>(lengths),
            static_cast<const int*>(starts), static_cast<QT*>(out), L, P, NH,
            ps, pps, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

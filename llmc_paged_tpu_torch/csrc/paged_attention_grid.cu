// NORMALIZED single-query paged attention over a paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of llmc_paged_tpu/ops/paged_attention.py:
//   * _make_paged_decode_grid_kernel(quant)  (entries
//     paged_decode_attention_grid and paged_decode_attention_quant_grid):
//     the kernel behind the normalized wrappers whenever the page size is
//     not a multiple of 128 (the CLI's default is 32), so it serves every
//     host-sampled decode step at those page sizes.
//
// Contract (the TPU kernel's): for each row b and head h, single-query
// attention over the row's live tokens [max(start, 0), len) read through
// the block table, f32 online softmax, output NORMALIZED and rounded once
// to q's dtype:
//   out (B, NH, HS) = acc / l, or exact zeros where l == 0.
// NEG_INF is -1e30 (never -inf); a score <= NEG_INF/2 gets p = 0, so a row
// with start >= len gives zeros. For int8 pools the per-(page, head, token)
// f32 scales apply after the dots: the K scale multiplies the token's
// score, the V scale its p (l sums p before it). The TPU kernel scales K
// and V before its dots: the same maths, rounded elsewhere.
//
// Layout: pages (P, NH, HS, ps) (token-minor), scales (P, NH, ps).
//
// Bound on the H100: bytes. At the CLI's shape (B=8, NH=12, HS=64, ps=32,
// lengths 65-128) a call reads about 5 MB of f32 K/V (1.5 us at 3.35 TB/s)
// or 1.5 MB of int8 K/V and scales (0.44 us), so its time is latency: the
// launch, the dependent loads of a row's length, a table entry and K/V,
// then one merge.
//
// Design: the TPU walks a sequential grid of (B, pages_per_seq) steps, one
// page a step, carrying m/l/acc in scratch memory. Here the grid is
// (B, NH), and two paths are chosen from the shape, never by a failure:
//   * ps % 4 == 0 and 4-element-aligned pools (every pool the engine
//     makes): the parts template (paged_attention_parts.cuh, QTILE = 1,
//     NORM). 8 warps split the row's live range in 32-token chunks across
//     pages; a lane loads 4 tokens x 16 head dims of K and V as vectors;
//     the warps' merge divides by l and rounds to q's dtype.
//   * any other page size or alignment: grid_scalar_kernel below, a lane
//     one token of a 32-token chunk of a page, 4 warps taking whole live
//     pages in turn, scalar loads and acc[HS] a lane (the first design).

#include "paged_attention_parts.cuh"

namespace {

using parts::NEG_INF;
using parts::to_f32;

constexpr int SCALAR_WARPS = 4;

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename QT, typename KV, bool QUANT, int HS>
__global__ void __launch_bounds__(SCALAR_WARPS * 32)
grid_scalar_kernel(const QT* __restrict__ q, const KV* __restrict__ k_pages,
                   const KV* __restrict__ v_pages,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ lengths,
                   const int* __restrict__ starts, QT* __restrict__ out,
                   int NH, int ps, int pps, float scale) {
  constexpr int THREADS = SCALAR_WARPS * 32;
  __shared__ float q_s[HS];
  __shared__ float acc_s[SCALAR_WARPS][HS];
  __shared__ float m_s[SCALAR_WARPS], l_s[SCALAR_WARPS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int start = max(starts[b], 0);   // a negative start reads from 0
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

  for (int i = warp; i < num; i += SCALAR_WARPS) {
    const int pidx = first + i;
    const size_t head = (size_t)tables[(size_t)b * pps + pidx] * NH + h;
    const KV* kp = k_pages + head * HS * ps;
    const KV* vp = v_pages + head * HS * ps;
    for (int c = 0; c < ps; c += 32) {
      const int t = c + lane;
      const int pos = pidx * ps + t;
      const bool valid = t < ps && pos < length && pos >= start;
      float s = NEG_INF, vsc = 1.f;
      if (valid) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HS; ++d)
          dot += q_s[d] * to_f32(kp[(size_t)d * ps + t]);
        s = dot * scale;
        if (QUANT) {
          s = s * k_scale[head * ps + t];
          vsc = v_scale[head * ps + t];
        }
      }
      const float m_new = fmaxf(m, parts::warp_max(s));
      const float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + p;                  // l takes p before the V scale
      const float pv = QUANT ? p * vsc : p;
      if (valid) {
#pragma unroll
        for (int d = 0; d < HS; ++d)
          acc[d] = acc[d] * alpha + pv * to_f32(vp[(size_t)d * ps + t]);
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

  for (int d = tid; d < HS; d += THREADS) {
    float M = m_s[0];
#pragma unroll
    for (int w = 1; w < SCALAR_WARPS; ++w) M = fmaxf(M, m_s[w]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < SCALAR_WARPS; ++w) {
      const float wt = expf(m_s[w] - M);
      a += wt * acc_s[w][d];
      L += wt * l_s[w];
    }
    parts::store(out + row * HS + d, a / (L == 0.f ? 1.f : L));
  }
}

// the template's vector path takes the call: 4-token pages, pools aligned
// to a 4-element vector of the pool's element kind
bool vector_path(int kv_kind, const void* k, const void* v, int ps) {
  const uintptr_t vec = parts::VEC * (kv_kind == parts::KIND_F32    ? 4
                                      : kv_kind == parts::KIND_BF16 ? 2
                                                                    : 1);
  return ps % parts::VEC == 0 && reinterpret_cast<uintptr_t>(k) % vec == 0 &&
         reinterpret_cast<uintptr_t>(v) % vec == 0;
}

}  // namespace

// q_kind: KIND_F32 | KIND_BF16 (out has q's kind). kv_kind: KIND_F32 |
// KIND_BF16 (ks/vs ignored) | KIND_I8 (ks/vs required). HS: 64; any page
// size. Returns cudaGetLastError() after the launch; an unsupported kind
// or head size returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_grid(int q_kind, int kv_kind, const void* q,
                                 const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* tables, const void* lengths,
                                 const void* starts, void* out, int B,
                                 int NH, int HS, int ps, int pps, float scale,
                                 void* stream) {
  if (vector_path(kv_kind, k, v, ps))
    return parts::launch<1, true>(q_kind, kv_kind, q, k, v, ks, vs, tables,
                                  lengths, starts, out, nullptr, nullptr, B,
                                  1, NH, HS, ps, pps, scale, stream);
  // acc[HS] is a register tile: one instance, 64 (every GPT-2 size's)
  if (HS != 64 || ps < 1 || B < 1 || NH < 1 || pps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return parts::dispatch_kinds(q_kind, kv_kind, [&](auto qt, auto kv,
                                                    auto quant) {
    using QT = typename decltype(qt)::type;
    using KV = typename decltype(kv)::type;
    grid_scalar_kernel<QT, KV, decltype(quant)::value, 64>
        <<<dim3(B, NH), SCALAR_WARPS * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const QT*>(q), static_cast<const KV*>(k),
            static_cast<const KV*>(v), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int*>(tables),
            static_cast<const int*>(lengths),
            static_cast<const int*>(starts), static_cast<QT*>(out), NH, ps,
            pps, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

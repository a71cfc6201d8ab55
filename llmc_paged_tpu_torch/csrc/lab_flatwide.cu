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
// its idea: no online rescaling, one max, one exp pass, one sum over a
// buffer of every live token's score.
//
// Bound on the H100: the parts kernel's, bytes: K/V (and int8 scales) of the
// live tokens, in the 32-byte sectors that hold them, at 3.35 TB/s. At the
// lab's decode shape the time is latency: the launch, the dependent loads
// length -> table entry -> K, the block max, then V.
//
// Design: two paths, chosen from the shape and the pointers
// (parts::vector_path), never by a failure.
//   * ps % 4 == 0 and pools (and int8 scales) aligned to a 4-element vector:
//     flatwide_vector_kernel, grid (B, NH), 8 warps, on the parts template's
//     loads (paged_attention_parts.cuh; its device helpers, not a copy). The
//     warps take the live range [start & ~3, min(len, pps * ps)) in 32-token
//     chunks across pages, three passes:
//       1. scores: lane (tg, dg) = (lane / 4, lane % 4) loads tokens
//          4tg..4tg+3 of head dims 16dg..16dg+15 of K, one vector a head dim
//          (4 B int8, 8 B bf16, 16 B f32; int8 converted by byte permutes),
//          one table entry a token group; the group's transposing shuffle
//          leaves lane dg the score of token 4tg+dg, which goes to the shared
//          score buffer (NEG_INF outside [start, len)); int8 and bf16 V,
//          and the int8 V scales, load here beside K and the warp's last
//          chunk's stay in registers (f32 V would double the registers);
//       2. one block max m, then p = exp(s - m) in place, 4 tokens a thread
//          as a 16-byte vector, summed into l;
//       3. PV, the warp's chunks backwards (the one in registers first):
//          the same lanes load V as vectors and p from shared memory (no
//          shuffle brings p), the int8 V scale multiplied into p as a
//          16-byte vector of the group's 4 token scales, loaded with V (not
//          in pass 2, where it would add a dependent global load after a
//          block barrier); acc[16 head dims] over the lane's 4 tokens; a
//          warp reduces its 8 token groups in 3 shuffle rounds and the
//          warps merge through shared memory as a plain sum (one global
//          max: no exp(m_w - M) weights).
//   * any other page size or alignment: flatwide_scalar_kernel below (the
//     first design): grid (B, NH), 4 warps; a thread a token scores q.K
//     with scalar loads into the same buffer, one block max, exp in place,
//     then the warps take 32-token chunks of PV, a lane a token holding
//     acc[HS], merged with shuffles and shared memory.
// Shared memory: pps * ps f32 scores (dynamic, opted in above 48 KB) plus
// 2.4 KB (vector) or 1.3 KB (scalar) of scratch; the wrapper raises above
// 227 KB (pps * ps up to 57,504 tokens).
//
// Tried and dropped (PERF.md §6): V prefetched into L2 in pass 1 (no gain
// at f32, none at int8 against V in registers); f32 V in registers too
// (158 registers: one block an SM, slower at the 1.5B head count). The
// first design alone took 12.16 (f32) and 13.53 (int8, bf16 q) us at the
// lab's decode shape (PERF.md §6).

#include "paged_attention_parts.cuh"

namespace {

using parts::NEG_INF;
using parts::to_f32;

constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// ---- the vector path -------------------------------------------------------

constexpr int VWARPS = 8;
constexpr int VTHREADS = VWARPS * 32;
constexpr int DPL = 64 / parts::GROUP;        // head dims a lane owns (HS 64)
// q (each lane group's 16 head dims padded to 20 floats, so that the 4
// groups' float4 reads fall on distinct banks), the warps' acc rows, their
// maxima and their l
constexpr size_t VSTATIC =
    sizeof(float) * (parts::GROUP * (DPL + parts::VEC) + VWARPS * 64 +
                     2 * VWARPS);

template <typename QT, typename KV, bool QUANT>
__global__ void __launch_bounds__(VTHREADS)
flatwide_vector_kernel(const QT* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       const int* __restrict__ starts,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int NH, int ps, int pps,
                       float scale) {
  using parts::CHUNK;
  using parts::GROUP;
  using parts::VEC;
  constexpr int HS = 64;
  // int8 and bf16 V (and int8 V scales) load with K in pass 1, the last
  // chunk's kept in registers (pass 3 walks the chunks backwards, so that
  // it starts with them); f32 V would double the registers and halve the
  // blocks an SM holds, so it loads in pass 3
  constexpr bool EARLY_V = sizeof(KV) < 4;
  using VT = typename parts::Vec<KV>::T;
  extern __shared__ __align__(16) float p_s[];   // [lo, lo + pps*ps): s, then p
  __shared__ __align__(16) float q_s[GROUP][DPL + VEC];
  __shared__ float acc_s[VWARPS][HS];
  __shared__ float m_s[VWARPS], l_s[VWARPS];

  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dg = lane % GROUP, tg = lane / GROUP;
  const int hi = min(lengths[b], pps * ps);
  const int start = max(starts[b], 0);
  const int lo = start & ~(VEC - 1);
  const int nchunks = start < hi ? (hi - lo + CHUNK - 1) / CHUNK : 0;
  const int ngroups = start < hi ? (hi - lo + VEC - 1) / VEC : 0;
  const int* trow = tables + (size_t)b * pps;
  const size_t row = (size_t)b * NH + h;

  for (int d = threadIdx.x; d < HS; d += VTHREADS)
    q_s[d / DPL][d % DPL] = to_f32(q[row * HS + d]);
  __syncthreads();

  // 1: every live token's score into p_s (each group's 4 slots written)
  float mloc = NEG_INF;
  VT vr[DPL];                  // EARLY_V: V of this warp's last chunk
  float4 vs4;                  // EARLY_V, int8: its V scales
  int clast = -1;              // this warp's last chunk
  for (int c = warp; c < nchunks; c += VWARPS) {
    const int pos0 = lo + c * CHUNK + tg * VEC;   // the group's first token
    const bool live = pos0 < hi;
    VT kr[DPL];
    float ksc = 1.f;
    clast = c;
    if (live) {
      const int pidx = pos0 / ps, t = pos0 - pidx * ps;
      const size_t head = (size_t)trow[pidx] * NH + h;
      const size_t off = (head * HS + dg * DPL) * ps + t;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[i] = parts::load_vec(k_pages + off + (size_t)i * ps);
        if constexpr (EARLY_V)
          vr[i] = parts::load_vec(v_pages + off + (size_t)i * ps);
      }
      if constexpr (QUANT) {
        ksc = __ldg(k_scale + head * ps + t + dg);
        vs4 = __ldg(reinterpret_cast<const float4*>(v_scale + head * ps + t));
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) kr[i] = VT{};
    }
    float s[VEC] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i4 = 0; i4 < DPL / 4; ++i4) {
      const float4 q4 = reinterpret_cast<const float4*>(q_s[dg])[i4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kf = parts::to_f32x4(kr[4 * i4 + u]);
        const float qq = parts::component(q4, u);
        s[0] += qq * kf.x;
        s[1] += qq * kf.y;
        s[2] += qq * kf.z;
        s[3] += qq * kf.w;
      }
    }
    float sc = parts::group_reduce(s, dg) * scale;
    if constexpr (QUANT) sc = sc * ksc;
    const int pos = pos0 + dg;                    // the token this lane scored
    if (live) {
      const bool valid = pos >= start && pos < hi;
      p_s[pos - lo] = valid ? sc : NEG_INF;
      if (valid) mloc = fmaxf(mloc, sc);
    }
  }

  // 2: one max; p = exp(s - m) in place, l before the V scale
  mloc = parts::warp_max(mloc);
  if (lane == 0) m_s[warp] = mloc;
  __syncthreads();
  float m = m_s[0];
#pragma unroll
  for (int w = 1; w < VWARPS; ++w) m = fmaxf(m, m_s[w]);
  float lloc = 0.f;
  for (int g = threadIdx.x; g < ngroups; g += VTHREADS) {
    float4 s4 = reinterpret_cast<const float4*>(p_s)[g];
    s4.x = s4.x > NEG_INF * 0.5f ? expf(s4.x - m) : 0.f;
    s4.y = s4.y > NEG_INF * 0.5f ? expf(s4.y - m) : 0.f;
    s4.z = s4.z > NEG_INF * 0.5f ? expf(s4.z - m) : 0.f;
    s4.w = s4.w > NEG_INF * 0.5f ? expf(s4.w - m) : 0.f;
    lloc += (s4.x + s4.y) + (s4.z + s4.w);
    reinterpret_cast<float4*>(p_s)[g] = s4;
  }
  lloc = parts::warp_sum(lloc);
  if (lane == 0) l_s[warp] = lloc;
  __syncthreads();                                // p_s complete

  // 3: acc = sum_t p_t (* v_scale_t) V[:, t], the chunks of pass 1 backwards
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int c = clast; c >= 0; c -= VWARPS) {
    const int pos0 = lo + c * CHUNK + tg * VEC;
    if (pos0 < hi) {
      const int pidx = pos0 / ps, t = pos0 - pidx * ps;
      const size_t head = (size_t)trow[pidx] * NH + h;
      const size_t off = (head * HS + dg * DPL) * ps + t;
      if (!EARLY_V || c != clast) {
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          vr[i] = parts::load_vec(v_pages + off + (size_t)i * ps);
        if constexpr (QUANT)
          vs4 = __ldg(
              reinterpret_cast<const float4*>(v_scale + head * ps + t));
      }
      float4 p4 = reinterpret_cast<const float4*>(p_s)[(pos0 - lo) / VEC];
      if constexpr (QUANT)
        p4 = make_float4(p4.x * vs4.x, p4.y * vs4.y, p4.z * vs4.z,
                         p4.w * vs4.w);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const float4 vf = parts::to_f32x4(vr[i]);
        acc[i] += p4.x * vf.x + p4.y * vf.y + p4.z * vf.z + p4.w * vf.w;
      }
    }
  }
  // each warp's acc over its 8 token groups, then the warps' plain sum
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    float a = acc[i];
    a += __shfl_xor_sync(parts::FULL, a, 4);
    a += __shfl_xor_sync(parts::FULL, a, 8);
    a += __shfl_xor_sync(parts::FULL, a, 16);
    if (tg == 0) acc_s[warp][dg * DPL + i] = a;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < HS; d += VTHREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < VWARPS; ++w) a += acc_s[w][d];
    acc_out[row * HS + d] = a;
  }
  if (threadIdx.x == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < VWARPS; ++w) l += l_s[w];
    m_out[row] = m;
    l_out[row] = l;
  }
}

// ---- the scalar path (the first design) ----------------------------------

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

// block-wide max (MAX) or sum, returned to every thread; red (WARPS floats)
// is free again on return
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? parts::warp_max(v) : parts::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

size_t scalar_smem_bytes(int HS, int ps, int pps) {
  return sizeof(float) * ((size_t)pps * ps + HS + (size_t)WARPS * HS + WARPS);
}

template <typename QT, typename KV, bool QUANT, int HS>
__global__ void __launch_bounds__(THREADS)
flatwide_scalar_kernel(const QT* __restrict__ q,
                       const KV* __restrict__ k_pages,
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
    const float a = parts::warp_sum(acc[d]);
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

// one launch of `kern` with `smem` bytes of dynamic shared memory (opted
// in above the default; `fixed` bytes of static beside it)
template <typename Kern, typename QT, typename KV>
cudaError_t launch_kernel(Kern kern, dim3 grid, int threads, size_t smem,
                          size_t fixed, cudaStream_t stream, const QT* q,
                          const KV* k, const KV* v, const void* ks,
                          const void* vs, const void* tables,
                          const void* lengths, const void* starts, void* acc,
                          void* m, void* l, int NH, int ps, int pps,
                          float scale) {
  if (smem + fixed > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem + fixed > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, stream>>>(
      q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), NH, ps, pps, scale);
  return cudaGetLastError();
}

}  // namespace

// Element kinds: parts::KIND_*, shared with the Python wrapper
// (ops/paged_attention.py's enum, which ops/dev/lab_flatwide.py uses).
// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). HS: 64; any page size. Returns
// cudaGetLastError() after the launch; an unsupported kind, head size or
// shared-memory size returns cudaErrorInvalidValue without launching.
extern "C" int flatwide_parts(int q_kind, int kv_kind, const void* q,
                              const void* k, const void* v, const void* ks,
                              const void* vs, const void* tables,
                              const void* lengths, const void* starts,
                              void* acc, void* m, void* l, int B, int NH,
                              int HS, int ps, int pps, float scale,
                              void* stream) {
  // acc is a register tile: one instance, head size 64 (every GPT-2 size's)
  if (HS != 64 || B < 1 || NH < 1 || ps < 1 || pps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = parts::vector_path(kv_kind, k, v, ks, vs, ps);
  const size_t scores = sizeof(float) * (size_t)pps * ps;
  return parts::dispatch_kinds(q_kind, kv_kind, [&](auto qt, auto kv,
                                                    auto quant) {
    using QT = typename decltype(qt)::type;
    using KV = typename decltype(kv)::type;
    constexpr bool QUANT = decltype(quant)::value;
    const auto go = [&](auto kern, int threads, size_t smem, size_t fixed) {
      return static_cast<int>(launch_kernel(
          kern, dim3(B, NH), threads, smem, fixed,
          static_cast<cudaStream_t>(stream), static_cast<const QT*>(q),
          static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,
          tables, lengths, starts, acc, m, l, NH, ps, pps, scale));
    };
    if (vec)
      return go(flatwide_vector_kernel<QT, KV, QUANT>, VTHREADS, scores,
                VSTATIC);
    return go(flatwide_scalar_kernel<QT, KV, QUANT, 64>, THREADS,
              scalar_smem_bytes(HS, ps, pps), 0);
  });
}

// Flash-decode "parts" over a paged KV pool, for Hopper (sm_90a): the one
// template behind the single-query kernel (paged_attention.cu, QTILE = 1),
// the multi-query kernel (paged_attention_mq.cu, QTILE = 4), with NORM the
// normalized grid kernel (paged_attention_grid.cu, QTILE = 1) and, with
// NORM and PLANE, the kernel lab's full-pool kernel (lab_full_pool.cu).
//
// Contract (the JAX package's parts contract): for each row b, query j and
// head h, attention over the row's live tokens [start, len) read through
// the block table, no causal mask inside the pool, f32 online softmax,
// UNNORMALIZED outputs acc (B, KQ, NH, HS), m (B, KQ, NH), l (B, KQ, NH),
// all f32 (KQ = 1 is the single-query layout (B, NH, HS)); with NORM the
// warps' merge writes acc / l instead (l == 0 -> 1, so a row with no live
// token gives exact zeros) in q's dtype, rounded once, and no m or l.
// Scores are multiplied by rsqrt(HS), then (int8) by the token's K scale.
// NEG_INF is -1e30 (never -inf); a score <= NEG_INF/2 gets p = 0; l sums p
// BEFORE the int8 V scale multiplies p; a row with no live token gives
// m = NEG_INF, l = 0, acc = 0. Layout: q (B, KQ, NH, HS) f32/bf16; pages
// (P, NH, HS, ps) token-minor; scales (P, NH, ps). All arithmetic is f32.
//
// Bound: bytes (K/V and scales of the live tokens) at the serving shapes,
// where the time is latency: the launch, then the dependent loads of a
// row's length, a table entry and K/V, then one merge. f32 operations for
// long query tiles (suffix prefill).
//
// Design. Grid (B, NH, ceil(KQ / QTILE)), 8 warps a block (4 when a call
// has several query tiles, see launch_typed). The row's live range
// [start & ~3, min(len, pps * ps)) is cut into 32-token chunks that the
// warps take in turn, across page boundaries: no block barrier inside the
// token loop. In a chunk, lane (tg, dg) = (lane / 4, lane % 4) loads
// tokens 4tg..4tg+3 of head dims 16dg..16dg+15 of K and of V, one vector a
// head dim (4 bytes int8, 8 bytes bf16, 16 bytes f32: a warp load reads 4
// whole 32-byte sectors or more), all 32 loads of a chunk independent.
// Each K element is used for every query of the tile from registers. The
// 4 lanes of a token group sum their partial dots with a transposing
// shuffle (3 shuffles a query), after which lane dg holds the score of
// token 4tg+dg. A warp keeps, per query, a warp-uniform running max m, a
// per-lane l and acc[16 head dims] over its tokens; p reaches the lanes
// that hold V by 4 shuffles. At the end each warp reduces its lanes and
// the warps merge through shared memory (weights exp(m_w - M); a warp with
// no live token has m_w = NEG_INF and l_w = acc_w = 0, so its weight of 1
// when M = NEG_INF adds nothing). int8 K/V convert to f32 by byte
// permutes and one exact subtraction, not by the quarter-rate
// integer-to-float instruction.
//
// PLANE (compiled out of every other instance): the pages are one plane of
// a stacked (L, P, NH, HS, ps) pool, scales (L, P, NH, ps). The layer is
// read from device memory (or given as a host int) and clamped to [0, L);
// the plane base, layer * P pages, is 64-bit; each live table entry is
// clamped to [0, P), so a bad one cannot read outside the pool; and int8
// scales multiply K and V before the dots (the full-pool contract), a
// 16-byte vector of the group's 4 token scales.
//
// Vector loads need a page size and pool alignment of 4 elements (the
// parts wrappers check both, the launch refuses ps % 4 != 0; the grid
// kernel's launcher takes a scalar kernel for the rest): a 4-token group
// then never straddles a page, and a window start or a row end inside a
// group is masked, never loaded around. Only the live table entries are
// read; page offsets are 64-bit. Shared memory is static (under 11 KB at
// QTILE = 4), so no launch opts in to more.
//
// Tried and dropped (PERF.md §6): splitting a row over a cluster of 2-4
// blocks merged through distributed shared memory. A block takes 79 to 255
// registers a thread, so one or two blocks fit an SM and the extra blocks
// ran in further waves: 1.5-4x slower at the serving shapes, and at
// 1,000-token rows faster in one case of four (7 %), slower in the rest.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace parts {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int VEC = 4;          // tokens a lane loads a head dim
constexpr int GROUP = 4;        // lanes that split one token group's head dims
constexpr int CHUNK = 32 / GROUP * VEC;     // tokens a warp takes a step

// element kinds, shared with the Python wrapper (ops/paged_attention.py)
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

template <typename KV> struct Vec;
template <> struct Vec<float> { using T = float4; };
template <> struct Vec<__nv_bfloat16> { using T = uint2; };
template <> struct Vec<int8_t> { using T = unsigned; };   // 4 bytes

template <typename KV>
__device__ __forceinline__ typename Vec<KV>::T load_vec(const KV* p) {
  return __ldg(reinterpret_cast<const typename Vec<KV>::T*>(p));
}

__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f32x4(uint2 u) {
  // little-endian bf16 pairs: a bf16 is the high half of its f32
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// 4 int8 -> f32 exactly: byte k of w = bits ^ 0x80808080 is x + 128;
// placed under the exponent of 2^23 it reads 2^23 + 128 + x
__device__ __forceinline__ float4 to_f32x4(unsigned bits) {
  const unsigned w = bits ^ 0x80808080u;
  constexpr float BIAS = 8388608.f + 128.f;
  return make_float4(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - BIAS,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - BIAS,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - BIAS,
                     __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - BIAS);
}

__device__ __forceinline__ float component(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// an f32 result stored in the output's dtype (bf16: round to nearest
// even, as torch's .to())
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// s[k] is this lane's partial dot for token k of its group; returns the
// full dot of token dg (the sum over the group's 4 lanes), with 3 shuffles:
// each step keeps half of the values and sends the other half across.
__device__ __forceinline__ float group_reduce(const float (&s)[VEC], int dg) {
  const bool up2 = dg & 2, up1 = dg & 1;
  const float a0 = (up2 ? s[2] : s[0]) +
                   __shfl_xor_sync(FULL, up2 ? s[0] : s[2], 2);
  const float a1 = (up2 ? s[3] : s[1]) +
                   __shfl_xor_sync(FULL, up2 ? s[1] : s[3], 2);
  return (up1 ? a1 : a0) + __shfl_xor_sync(FULL, up1 ? a0 : a1, 1);
}

// acc_out: f32 parts, or with NORM the normalized output in q's dtype
template <typename QT, bool NORM>
using AccOut = std::conditional_t<NORM, QT, float>;

// the plane of a stacked pool that a PLANE instance reads: the layer in
// device memory, or layer_host where layer is null
struct Plane {
  const int* layer;
  int layer_host, L, P;
};

template <typename QT, typename KV, bool QUANT, int HS, int QTILE,
          int WARPS, bool NORM = false, bool PLANE = false>
__global__ void __launch_bounds__(WARPS * 32)
parts_kernel(const QT* __restrict__ q, const KV* __restrict__ k_pages,
             const KV* __restrict__ v_pages,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ tables, const int* __restrict__ lengths,
             const int* __restrict__ starts,
             AccOut<QT, NORM>* __restrict__ acc_out,
             float* __restrict__ m_out, float* __restrict__ l_out, int KQ,
             int NH, int ps, int pps, float scale, Plane pl) {
  constexpr int THREADS = WARPS * 32;
  constexpr int DPL = HS / GROUP;       // head dims a lane owns
  // V is loaded with K, except under a query tile for f32 pools, and for
  // bf16 pools at head_dim 128, where acc and the K and V tiles would not
  // fit the registers together
  constexpr bool EARLY_V =
      QTILE == 1 || sizeof(KV) == 1 || (sizeof(KV) < 4 && HS == 64);
  // at head_dim 128 the query tiles of a (row, head) are the grid's
  // fastest axis: the tiles that walk the same pages run side by side,
  // and every walk after the first reads them from L2
  constexpr bool TILES_FIRST = HS == 128;
  using VT = typename Vec<KV>::T;
  // q, each lane group's 16 head dims padded to 20 floats so that the 4
  // groups' float4 reads fall on distinct banks
  __shared__ __align__(16) float q_s[QTILE][GROUP][DPL + VEC];
  __shared__ float acc_s[WARPS][QTILE][HS];
  __shared__ float m_s[WARPS][QTILE], l_s[WARPS][QTILE];

  const int b = TILES_FIRST ? blockIdx.z : blockIdx.x, h = blockIdx.y;
  const int q0 = (TILES_FIRST ? blockIdx.x : blockIdx.z) * QTILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dg = lane % GROUP, tg = lane / GROUP;

  const int hi = min(lengths[b], pps * ps);
  const int start = max(starts[b], 0);
  const int lo = start & ~(VEC - 1);
  const int nchunks = start < hi ? (hi - lo + CHUNK - 1) / CHUNK : 0;
  size_t plane = 0;                     // pages before the layer's plane
  if constexpr (PLANE)
    plane = (size_t)min(max(pl.layer ? __ldg(pl.layer) : pl.layer_host, 0),
                        pl.L - 1) * pl.P;

  for (int e = threadIdx.x; e < QTILE * HS; e += THREADS) {
    const int j = e / HS, d = e - j * HS;
    q_s[j][d / DPL][d % DPL] =
        q0 + j < KQ ? to_f32(q[(((size_t)b * KQ + q0 + j) * NH + h) * HS + d])
                    : 0.f;
  }
  __syncthreads();

  float m[QTILE], l[QTILE], acc[QTILE][DPL];
#pragma unroll
  for (int j = 0; j < QTILE; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }

  for (int c = warp; c < nchunks; c += WARPS) {
    const int pos0 = lo + c * CHUNK + tg * VEC;   // the group's first token
    const bool live = pos0 < hi;
    VT kr[DPL], vr[DPL];
    size_t vrow = 0;
    float ksc = 1.f, vsc = 1.f;
    float4 ks4, vs4;                      // PLANE: the group's token scales
    if (live) {
      const int pidx = pos0 / ps, t = pos0 - pidx * ps;
      size_t head;
      if constexpr (PLANE)
        head = (plane + min(max(tables[(size_t)b * pps + pidx], 0),
                            pl.P - 1)) * NH + h;
      else
        head = (size_t)tables[(size_t)b * pps + pidx] * NH + h;
      const size_t row = (head * HS + dg * DPL) * ps + t;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[i] = load_vec(k_pages + row + (size_t)i * ps);
        if (EARLY_V) vr[i] = load_vec(v_pages + row + (size_t)i * ps);
      }
      if (!EARLY_V) vrow = row;
      if constexpr (QUANT && PLANE) {
        ks4 = __ldg(reinterpret_cast<const float4*>(k_scale + head * ps + t));
        vs4 = __ldg(reinterpret_cast<const float4*>(v_scale + head * ps + t));
      } else if (QUANT) {
        ksc = __ldg(k_scale + head * ps + t + dg);
        vsc = __ldg(v_scale + head * ps + t + dg);
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) kr[i] = vr[i] = VT{};
      if constexpr (QUANT && PLANE)
        ks4 = vs4 = make_float4(1.f, 1.f, 1.f, 1.f);
    }
    const int pos = pos0 + dg;                    // the token this lane scores
    const bool valid = live && pos >= start && pos < hi;

    // scores: head dim outer, queries inner, so that one K vector is
    // converted at a time and used for every query of the tile
    float s[QTILE][VEC];
#pragma unroll
    for (int j = 0; j < QTILE; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[j][k] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < DPL / 4; ++i4) {
      float4 q4[QTILE];
#pragma unroll
      for (int j = 0; j < QTILE; ++j)
        q4[j] = reinterpret_cast<const float4*>(q_s[j][dg])[i4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 kf = to_f32x4(kr[4 * i4 + u]);
        if constexpr (QUANT && PLANE)      // dequantize before the dot
          kf = make_float4(kf.x * ks4.x, kf.y * ks4.y, kf.z * ks4.z,
                           kf.w * ks4.w);
#pragma unroll
        for (int j = 0; j < QTILE; ++j) {
          const float qq = component(q4[j], u);
          s[j][0] += qq * kf.x;
          s[j][1] += qq * kf.y;
          s[j][2] += qq * kf.z;
          s[j][3] += qq * kf.w;
        }
      }
    }
    float pv[QTILE], alpha[QTILE];
#pragma unroll
    for (int j = 0; j < QTILE; ++j) {
      float sc = group_reduce(s[j], dg) * scale;
      if (QUANT && !PLANE) sc = sc * ksc;
      if (!valid) sc = NEG_INF;
      const float m_new = fmaxf(m[j], warp_max(sc));
      const float p = sc > NEG_INF * 0.5f ? expf(sc - m_new) : 0.f;
      alpha[j] = expf(m[j] - m_new);
      l[j] = l[j] * alpha[j] + p;           // l takes p before the V scale
      pv[j] = QUANT && !PLANE ? p * vsc : p;
      m[j] = m_new;
    }
    if (!EARLY_V && live) {
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        vr[i] = load_vec(v_pages + vrow + (size_t)i * ps);
    }
    // p of the group's 4 tokens, from the lanes that scored them
    float pg[QTILE][VEC];
#pragma unroll
    for (int j = 0; j < QTILE; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        pg[j][k] = __shfl_sync(FULL, pv[j], (lane & ~(GROUP - 1)) + k);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      float4 vf = to_f32x4(vr[i]);
      if constexpr (QUANT && PLANE)
        vf = make_float4(vf.x * vs4.x, vf.y * vs4.y, vf.z * vs4.z,
                         vf.w * vs4.w);
#pragma unroll
      for (int j = 0; j < QTILE; ++j)
        acc[j][i] = acc[j][i] * alpha[j] + pg[j][0] * vf.x + pg[j][1] * vf.y +
                    pg[j][2] * vf.z + pg[j][3] * vf.w;
    }
  }

  // each warp's (m, l, acc) over its lanes
#pragma unroll
  for (int j = 0; j < QTILE; ++j) {
    const float lw = warp_sum(l[j]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      float a = acc[j][i];
      a += __shfl_xor_sync(FULL, a, 4);
      a += __shfl_xor_sync(FULL, a, 8);
      a += __shfl_xor_sync(FULL, a, 16);
      if (tg == 0) acc_s[warp][j][dg * DPL + i] = a;
    }
    if (lane == 0) {
      m_s[warp][j] = m[j];
      l_s[warp][j] = lw;
    }
  }
  __syncthreads();

  // the warps' merge
  for (int o = threadIdx.x; o < QTILE * HS; o += THREADS) {
    const int j = o / HS, d = o - j * HS;
    if (q0 + j >= KQ) continue;
    float M = m_s[0][j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, m_s[w][j]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(m_s[w][j] - M);
      a += wt * acc_s[w][j][d];
      L += wt * l_s[w][j];
    }
    const size_t r = ((size_t)b * KQ + q0 + j) * NH + h;
    if constexpr (NORM) {
      store(acc_out + r * HS + d, a / (L == 0.f ? 1.f : L));
    } else {
      acc_out[r * HS + d] = a;
      if (d == 0) {
        m_out[r] = M;
        l_out[r] = L;
      }
    }
  }
}

// One launch on `stream`, one block a (row, head, query tile): 8 warps, or
// 4 when a multi-query call has several query tiles. With NORM, `acc` is
// the normalized (B, KQ, NH, HS) output in q's dtype and m, l are unused.
// Returns cudaGetLastError() after the launch; an unsupported head size or
// page size returns cudaErrorInvalidValue without launching.
template <typename QT, typename KV, bool QUANT, int QTILE, bool NORM,
          bool PLANE>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* tables,
                         const void* lengths, const void* starts, void* acc,
                         void* m, void* l, int B, int KQ, int NH, int HS,
                         int ps, int pps, float scale, cudaStream_t stream,
                         Plane pl) {
  // the smem q tile and acc are sized by the head size: one instance a
  // head size, 64 (every GPT-2 size's) and, outside the normalized and
  // lab instances, 128 (Mellum's); another is one more case here and in
  // the wrapper
  constexpr bool WIDE = !NORM && !PLANE;
  if ((HS != 64 && !(WIDE && HS == 128)) || ps < VEC || ps % VEC != 0 ||
      B < 1 || KQ < 1 || NH < 1 || pps < 1 ||
      (PLANE && (pl.L < 1 || pl.P < 1)))
    return cudaErrorInvalidValue;
  const int tiles = (KQ + QTILE - 1) / QTILE;
  dim3 grid(B, NH, tiles);
  const auto args = [&](auto kern, int warps) {
    kern<<<grid, warps * 32, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(tables),
        static_cast<const int*>(lengths), static_cast<const int*>(starts),
        static_cast<AccOut<QT, NORM>*>(acc), static_cast<float*>(m),
        static_cast<float*>(l), KQ, NH, ps, pps, scale, pl);
  };
  // Several query tiles make many blocks of up to 255 registers a thread:
  // one 8-warp block fits an SM and idles through its merge, where two
  // 4-warp blocks overlap one's merge with the other's loads (faster at the
  // suffix-prefill shapes, PERF.md §6). One tile (spec verify, the
  // single-query kernel) keeps 8 warps: one 32-token chunk each at the
  // serving lengths.
  // A group of 8 query heads at head_dim 128 is two tiles of 4: a tile
  // of 8 would hold 256 accumulators a lane, more registers than a
  // thread has.
  const auto run = [&](auto hs) {
    constexpr int H = decltype(hs)::value;
    if (H == 128) grid = dim3(tiles, NH, B);    // the kernel's TILES_FIRST
    if constexpr (QTILE > 1) {
      if (KQ > QTILE) {
        args(parts_kernel<QT, KV, QUANT, H, QTILE, 4, NORM, PLANE>, 4);
        return;
      }
    }
    args(parts_kernel<QT, KV, QUANT, H, QTILE, 8, NORM, PLANE>, 8);
  };
  if constexpr (WIDE) {
    if (HS == 128) {
      run(std::integral_constant<int, 128>{});
      return cudaGetLastError();
    }
  }
  run(std::integral_constant<int, 64>{});
  return cudaGetLastError();
}

// The vector kernels take a call: 4-token pages, pools (and int8 scales)
// aligned to a 4-element vector of their element kind. The lab kernels
// that keep a scalar kernel for the rest (lab_full_pool.cu,
// lab_flatwide.cu) choose by it.
inline bool vector_path(int kv_kind, const void* k, const void* v,
                        const void* ks, const void* vs, int ps) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const uintptr_t vec = VEC * (kv_kind == KIND_F32    ? 4
                               : kv_kind == KIND_BF16 ? 2
                                                      : 1);
  return ps % VEC == 0 && aligned(k, vec) && aligned(v, vec) &&
         (kv_kind != KIND_I8 || (aligned(ks, 4 * VEC) && aligned(vs, 4 * VEC)));
}

template <typename T> struct Type { using type = T; };

// Calls f(Type<QT>{}, Type<KV>{}, std::bool_constant<QUANT>{}) for the
// element kinds: q KIND_F32 | KIND_BF16; kv KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). Another kind returns
// cudaErrorInvalidValue.
template <typename F>
int dispatch_kinds(int q_kind, int kv_kind, F&& f) {
  const auto with_kv = [&](auto qt) -> int {
    if (kv_kind == KIND_F32) return f(qt, Type<float>{}, std::false_type{});
    if (kv_kind == KIND_BF16)
      return f(qt, Type<__nv_bfloat16>{}, std::false_type{});
    if (kv_kind == KIND_I8) return f(qt, Type<int8_t>{}, std::true_type{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (q_kind == KIND_F32) return with_kv(Type<float>{});
  if (q_kind == KIND_BF16) return with_kv(Type<__nv_bfloat16>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// One launch of the template for the element kinds (dispatch_kinds);
// `pl` is read by PLANE instances only.
template <int QTILE, bool NORM = false, bool PLANE = false>
int launch(int q_kind, int kv_kind, const void* q, const void* k,
           const void* v, const void* ks, const void* vs, const void* tables,
           const void* lengths, const void* starts, void* acc, void* m,
           void* l, int B, int KQ, int NH, int HS, int ps, int pps,
           float scale, void* stream, Plane pl = Plane{}) {
  return dispatch_kinds(q_kind, kv_kind, [&](auto qt, auto kv, auto quant) {
    return static_cast<int>(
        launch_typed<typename decltype(qt)::type, typename decltype(kv)::type,
                     decltype(quant)::value, QTILE, NORM, PLANE>(
            q, k, v, ks, vs, tables, lengths, starts, acc, m, l, B, KQ, NH,
            HS, ps, pps, scale, static_cast<cudaStream_t>(stream), pl));
  });
}

}  // namespace parts

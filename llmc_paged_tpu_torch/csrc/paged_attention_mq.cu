// Multi-query flash-decode "parts" over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_flash_decode_flat_mq_kernel(B, KQ, quant)
// of llmc_paged_tpu/ops/paged_attention.py (float pools, and int8 pools
// with pinned scales or scale_dma), entries
// paged_decode_attention[_quant]_parts_mq. It serves speculative verify
// (KQ = spec_k) and prefix-cache suffix prefill (KQ = the suffix bucket).
// The TPU kernel's T <= 64 suffix cut (a VMEM limit) does not exist here:
// any KQ is taken, in tiles of up to QT_MAX queries.
//
// Contract (the JAX package's parts contract with a KQ axis): for each
// row b, query j and head h, attention over the row's live pages
// [start/ps, (len-1)/ps] read through the block table, positions outside
// [start, len) masked, no causal mask inside the pool (every query sits
// at or past len), f32 online softmax, UNNORMALIZED outputs
//   acc (B, KQ, NH, HS) f32, m (B, KQ, NH) f32, l (B, KQ, NH) f32.
// Scores are multiplied by rsqrt(HS), then (int8) by the per-token K
// scale. NEG_INF is -1e30 (never -inf); a lane whose score is <=
// NEG_INF/2 gets p = 0; l sums p BEFORE the int8 V scale multiplies p; a
// row with length 0, or fully masked, gives m = NEG_INF, l = 0, acc = 0.
//
// Layout: q (B, KQ, NH, HS) f32/bf16; pages (P, NH, HS, ps) token-minor;
// scales (P, NH, ps).
//
// Design: grid (B, NH, ceil(KQ/qtile)), 128 threads, qtile = min(KQ,
// QT_MAX). The point of the TPU kernel is ONE page walk for all KQ
// queries, and that holds per tile: a block stages each live page's K
// (HS x ps) and V (HS x (ps+1), padded so that threads on neighbouring
// head dims hit distinct banks) and its scales once in shared memory,
// converted to f32, and scores its whole query tile against it. Scores:
// thread per (query, token), reading neighbouring tokens of one head dim.
// Softmax update: a warp per query. PV: thread per (query, head dim), a
// loop over the page's tokens. spec_k <= 16 fits one tile, so a verify
// step reads each page once per (row, head); a suffix of T queries reads
// it ceil(T/16) times (from L2 after the first).
//
// Bound on the H100: at the spec-verify shapes (B=8, KQ=4, NH=12, HS=64,
// ps=128, 2 live pages a row) a call reads 8-16 live pages (int8: 208,896
// B each with scales) and does 4*KQ*tokens*NH*HS f32 operations: bytes
// bound (~1 us at 3.35 TB/s vs ~0.3 us of f32 work). For long suffixes
// (KQ in the hundreds) the operations bound it. The f32 products run on
// the CUDA cores; mma.sync/wgmma tiles, cp.async/TMA staging and split-K
// over pages are left to later work.
//
// Shared memory, f32: q and acc (qtile*HS each) | K page (HS*ps) | V page
// (HS*(ps+1)) | scores (qtile*ps) | scales (2*ps) | m, l, alpha (3*qtile).
// At qtile=16, HS=64, ps=128 that is 83 KB: above 48 KB the launch opts
// in with cudaFuncSetAttribute (Hopper allows 227 KB a block).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int QT_MAX = 16;
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

size_t smem_bytes(int qtile, int HS, int ps) {
  return sizeof(float) *
         ((size_t)2 * qtile * HS + (size_t)HS * ps + (size_t)HS * (ps + 1) +
          (size_t)qtile * ps + 2 * (size_t)ps + 3 * (size_t)qtile);
}

template <typename QType, typename KV, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_decode_parts_mq_kernel(const QType* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             const int* __restrict__ starts,
                             float* __restrict__ acc_out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int KQ, int NH,
                             int HS, int ps, int pps, int qtile,
                             float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // qtile * HS
  float* acc_s = q_s + qtile * HS;       // qtile * HS
  float* k_s = acc_s + qtile * HS;       // HS * ps
  float* v_s = k_s + HS * ps;            // HS * (ps + 1)
  float* s_s = v_s + HS * (ps + 1);      // qtile * ps: scores, then p
  float* ks_s = s_s + qtile * ps;        // ps
  float* vs_s = ks_s + ps;               // ps
  float* m_s = vs_s + ps;                // qtile
  float* l_s = m_s + qtile;              // qtile
  float* a_s = l_s + qtile;              // qtile: this page's alpha

  const int b = blockIdx.x, h = blockIdx.y;
  const int q0 = blockIdx.z * qtile;
  const int nq = min(qtile, KQ - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const int start = starts[b];
  const int first = start / ps;
  const int last = length > 0 ? (length - 1) / ps : -1;
  const int num = max(last - first + 1, 0);

  for (int e = tid; e < nq * HS; e += THREADS) {
    const int qi = e / HS, d = e - qi * HS;
    q_s[e] = to_f32(q[(((size_t)b * KQ + q0 + qi) * NH + h) * HS + d]);
    acc_s[e] = 0.f;
  }
  for (int qi = tid; qi < nq; qi += THREADS) {
    m_s[qi] = NEG_INF;
    l_s[qi] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < num; ++i) {
    const int pidx = first + i;
    const int page = tables[(size_t)b * pps + pidx];
    const size_t head = (size_t)page * NH + h;
    const KV* kp = k_pages + head * HS * ps;
    const KV* vp = v_pages + head * HS * ps;

    // 1: stage the page (and its scales) once for the whole query tile
    for (int e = tid; e < HS * ps; e += THREADS) {
      const int d = e / ps, t = e - d * ps;
      k_s[e] = to_f32(kp[e]);
      v_s[d * (ps + 1) + t] = to_f32(vp[e]);
    }
    if (QUANT) {
      for (int t = tid; t < ps; t += THREADS) {
        ks_s[t] = k_scale[head * ps + t];
        vs_s[t] = v_scale[head * ps + t];
      }
    }
    __syncthreads();

    // 2: scores of every (query, token) pair, scaled, masked
    for (int e = tid; e < nq * ps; e += THREADS) {
      const int qi = e / ps, t = e - qi * ps;
      const float* qr = q_s + qi * HS;
      float s = 0.f;
      for (int d = 0; d < HS; ++d) s += qr[d] * k_s[d * ps + t];
      s = s * scale;
      if (QUANT) s = s * ks_s[t];
      const int pos = pidx * ps + t;
      if (!(pos < length && pos >= start)) s = NEG_INF;
      s_s[e] = s;
    }
    __syncthreads();

    // 3: online-softmax update, a warp per query
    for (int qi = warp; qi < nq; qi += WARPS) {
      float* row = s_s + qi * ps;
      float mloc = NEG_INF;
      for (int t = lane; t < ps; t += 32) mloc = fmaxf(mloc, row[t]);
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, warp_max(mloc));
      float lloc = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float s = row[t];
        float p = s > NEG_INF * 0.5f ? expf(s - m_new) : 0.f;
        lloc += p;                      // l takes p before the V scale
        if (QUANT) p = p * vs_s[t];
        row[t] = p;
      }
      lloc = warp_sum(lloc);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[qi] = alpha;
        l_s[qi] = l_s[qi] * alpha + lloc;
        m_s[qi] = m_new;
      }
    }
    __syncthreads();

    // 4: PV, a thread per (query, head dim)
    for (int o = tid; o < nq * HS; o += THREADS) {
      const int qi = o / HS, d = o - qi * HS;
      const float* pr = s_s + qi * ps;
      const float* vr = v_s + d * (ps + 1);
      float part = 0.f;
      for (int t = 0; t < ps; ++t) part += pr[t] * vr[t];
      acc_s[o] = acc_s[o] * a_s[qi] + part;
    }
    __syncthreads();                    // the next page overwrites k_s..a_s
  }

  for (int o = tid; o < nq * HS; o += THREADS) {
    const int qi = o / HS, d = o - qi * HS;
    acc_out[(((size_t)b * KQ + q0 + qi) * NH + h) * HS + d] = acc_s[o];
  }
  for (int qi = tid; qi < nq; qi += THREADS) {
    const size_t r = ((size_t)b * KQ + q0 + qi) * NH + h;
    m_out[r] = m_s[qi];
    l_out[r] = l_s[qi];
  }
}

template <typename QType, typename KV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, const void* starts, void* acc,
                   void* m, void* l, int B, int KQ, int NH, int HS, int ps,
                   int pps, int qtile, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(qtile, HS, ps);
  if (qtile < 1 || qtile > QT_MAX || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kern = flash_decode_parts_mq_kernel<QType, KV, QUANT>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, NH, (KQ + qtile - 1) / qtile);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const QType*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), KQ, NH, HS, ps, pps, qtile, scale);
  return cudaGetLastError();
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/paged_attention.py).
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_I8 = 2 };

// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). qtile: queries per block,
// 1..16. Returns cudaGetLastError() after the launch; an unsupported
// kind, tile or shared-memory size returns cudaErrorInvalidValue without
// launching.
extern "C" int flash_decode_parts_mq(int q_kind, int kv_kind, const void* q,
                                     const void* k, const void* v,
                                     const void* ks, const void* vs,
                                     const void* tables, const void* lengths,
                                     const void* starts, void* acc, void* m,
                                     void* l, int B, int KQ, int NH, int HS,
                                     int ps, int pps, int qtile, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(QTY, KV, QUANT)                                             \
  return static_cast<int>(launch<QTY, KV, QUANT>(                         \
      q, k, v, ks, vs, tables, lengths, starts, acc, m, l, B, KQ, NH, HS,  \
      ps, pps, qtile, scale, s))
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

// Causal flash attention over bf16 (B, NH, T, HS) heads for Hopper
// (sm_90a), on wgmma and TMA: the long-prompt prefill's attention.
//
// Replaces the TPU kernel that llmc_paged_tpu/ops/layers.py:86
// (causal_attention_flash) calls: JAX's bundled Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention with causal=True and
// sm_scale = 1/sqrt(HS), which prefill_attention takes for bf16 q with
// T >= 256 and T % 128 == 0. Entry causal_attention_flash of
// llmc_paged_tpu_torch/ops/flash_attention.py; its plain version,
// causal_attention_flash_ref, repeats the TPU kernel's arithmetic.
//
// Contract: out = softmax(q k^T * sm_scale, causal) v over bf16 heads of
// HS = 64, T % 128 == 0, any B and NH. q, k, v and out are strided views
// (batch, head, token strides, each a multiple of 8 elements; the last dim
// contiguous; 16-byte aligned bases), so the heads the model cuts from its
// qkv product and the (B, T, NH, HS) output it reshapes need no copy.
// s = q k^T accumulates in f32 from the bf16 inputs and is scaled after the
// product; only keys above the diagonal are masked; the softmax is online
// over key tiles with the running max and sum in f32; p = exp(s - m)
// rounds to bf16 before the p v product, which accumulates in f32; l sums
// the f32 p; the output is normalized once and rounds once to bf16. Key
// tiles wholly above the diagonal are skipped. What differs from the TPU
// kernel is the order of the f32 sums: exp2 of s * sm_scale * log2(e) - m
// in one fused multiply-add, and the accumulator normalized once at the
// end (the TPU kernel rescales it by 1/l every tile), so p's bf16 rounding
// falls at other points: within 2^-7 |plain| + 2e-3 of the plain version
// (chip_smoke.py phase 14).
//
// Bounds on the H100 at the 124M long-context wave (B, NH, T) = (8, 12, 896):
// the bytes, q, k and v read once and out written once, 44.0 MB at
// 3.35 TB/s = 13.1 us; the causal products, 4 * HS * B * NH * T(T+1)/2 =
// 9.9 GFLOP at 989 TFLOP/s bf16, 10.0 us; the exponentials, one a
// query-key pair at or below the diagonal (41 M, 16 a clock on each of 132
// SMs), about 10 us. Three bounds of one size, so the design overlaps
// them:
// - the products on wgmma, the only way to the tensor cores' full rate:
//   S = Q K^T as m64n128k16 with both operands from shared memory (K-major,
//   4 k-steps), O += P V as m64n64k16 with P as the register A operand (the
//   f32 S accumulator rounded to bf16 pairs is the A fragment layout) and V
//   from shared memory as an MN-major B (the transpose bit: no transposed
//   copy of V), 8 k-steps;
// - the bytes through TMA: one producer thread issues every load (4-D
//   tensor maps (HS, T, NH, B) over the strided heads, 128-byte swizzle, one
//   128 B row of HS = 64 a line), q a tile, K and V in 128-key tiles of
//   16 KB into a ring of STAGES stages that complete full barriers; the
//   consumers release a stage (and q, after their last Q K^T) through empty
//   barriers; no block-wide barrier in the key loop. 128-row query tiles
//   read each K/V tile half as often as 64-row tiles did;
// - the exponentials under the products: two consumer warpgroups of 64
//   query rows each take turns on named barriers to issue their products,
//   so one's softmax runs while the other's wgmma does, and within a
//   warpgroup the next tile's Q K^T and this tile's P V are issued together
//   and the softmax of the one runs under the other. The diagonal tile's
//   mask is a separate instance of the softmax, so the others carry none.
// Work items are (b, h, 128-row query tile); one persistent block of 3
// warpgroups a SM (two consumers, setmaxnreg up to 232 registers, and a
// producer, down to 40) walks them, the items with the most key tiles
// first and snaking over the blocks, so the causal imbalance evens out;
// the producer runs ahead into the next item as the ring frees. 129 KB of
// dynamic shared memory (above the 48 KB default through
// cudaFuncSetAttribute). Each consumer stages its normalized bf16 output
// (swizzled, free of bank conflicts) and stores 16 bytes a lane.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 14;
// PERF.md): 33.6 us at (8, 12, 896), 2.6 times its bound. What is left is
// most likely the K/V traffic from L2: each K/V tile is read once per
// query tile at or below it, 88 MB in all at that shape (PERF.md section 7).
// The previous design, for the record: 4 warps on mma.sync m16n8k16, 64-row
// query tiles, a cp.async ring of two 64-key tiles, contiguous heads only;
// 49.45 us at (8, 12, 896) on the same card.

#include <cuda.h>          // CUtensorMap and its enums (types only, no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;             // head size (every GPT-2 size)
constexpr int BM = 128;            // query rows a block
constexpr int BN = 128;            // keys a tile
constexpr int CONSUMERS = 2;       // warpgroups of 64 query rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 3;          // K/V ring depth
constexpr int TILE = 128 * HS * 2; // bytes of a 128-row tile: 16 KB
constexpr int T_ALIGN = 128;       // the TPU kernel's block: T % 128 == 0
constexpr int NBARS = 2 + 4 * STAGES;
constexpr int SMEM_BYTES = (2 + 2 * STAGES) * TILE + 8 * NBARS + 1024;
constexpr float LOG2E = 1.4426950408889634f;
// named barriers (0 is __syncthreads): the consumers' turns, then each
// consumer's own epilogue barrier
constexpr int BAR_TURN = 1, BAR_EPI = 3;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// spin until the barrier's phase differs from ``parity``
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of the 4-D map at (c0, c1, c2, c3) into shared memory; its bytes
// complete ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses to wgmma registers across an
// issue or a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (64 x 128, f32) (+)= a (64 x 16, smem, K-major) * b (16 x 128, smem,
// K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += a (64 x 16 bf16, registers) * b (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// S = Q K^T of one key tile: 4 k-steps of 16 head dims, 32 bytes apart in
// the swizzled 128-byte rows (8-row groups 1024 bytes apart)
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t sq,
                                         uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    wgmma_m64n128(s, sw128_desc(sq + 32 * kk, 16, 1024),
                  sw128_desc(sk + 32 * kk, 16, 1024), kk);
}

// O += P V of one key tile: 8 k-steps of 16 keys (2048 bytes of V each);
// P's A fragment of step kk is p[4kk .. 4kk + 3]
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&p)[32],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_m64n64_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                    p[4 * kk + 3], sw128_desc(sv + 2048 * kk, 1024, 1024));
}

// max (or sum) of the 16 values v[0..15] as a tree: 4 dependent steps
// where a running chain takes 15
template <bool SUM>
__device__ __forceinline__ float op(float a, float b) {
  return SUM ? a + b : fmaxf(a, b);
}

template <bool SUM>
__device__ __forceinline__ float tree16(float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = op<SUM>(v[i], v[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = op<SUM>(v[i], v[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = op<SUM>(v[i], v[i + 2]);
  return op<SUM>(v[0], v[1]);
}

// The online softmax of one tile of scores in place: s (this thread's two
// rows, r0 and r0 + 8 of the block's query tile: element 4n + c is row
// r0 + 8 (c >> 1), key 8n + 2t + (c & 1)) becomes p = exp2(s * scale_log2 -
// m) in f32; m (in the exp2 domain) and the row sums' partial sums update,
// and alpha holds the factor the accumulator must take. DIAG: the tile on
// the diagonal, whose keys above each row are masked.
template <bool DIAG>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int r0, int t, float scale_log2) {
  if (DIAG) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (8 * n + 2 * t + (c & 1) > r0 + 8 * (c >> 1))
          s[4 * n + c] = -INFINITY;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[16];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
      v[n] = fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
    float mx = tree16<false>(v);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx * scale_log2);  // finite: key 0 or the
    alpha[r] = ex2(m[r] - mn);                       // diagonal is below
    m[r] = mn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[16];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float p0 = ex2(fmaf(s[4 * n + 2 * r], scale_log2, -m[r]));
      const float p1 = ex2(fmaf(s[4 * n + 2 * r + 1], scale_log2, -m[r]));
      s[4 * n + 2 * r] = p0;
      s[4 * n + 2 * r + 1] = p1;
      v[n] = p0 + p1;
    }
    l[r] = l[r] * alpha[r] + tree16<true>(v);
  }
}

// p rounded to bf16 pairs: n8 tile n gives p[2n] (row r0) and p[2n + 1]
// (row r0 + 8), so k16 step kk is tiles 2kk, 2kk + 1: the A fragment
__device__ __forceinline__ void pack_p(uint32_t (&p)[32],
                                       const float (&s)[64]) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    p[2 * n] = pack_bf16(s[4 * n], s[4 * n + 1]);
    p[2 * n + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
  }
}

struct Bars {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t q_empty() const { return base + 8; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t v_full(int s) const {
    return base + 8 * (2 + STAGES + s);
  }
  __device__ uint32_t k_empty(int s) const {
    return base + 8 * (2 + 2 * STAGES + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return base + 8 * (2 + 3 * STAGES + s);
  }
};

// The work items, (b, h, query tile), listed with the most key tiles
// first: item i is query tile nqt - 1 - i / BH of (b, h) = i % BH. Block w
// of G takes items round by round, w in even rounds and G - 1 - w in odd
// ones (a snake over the sorted list, so the sums of key tiles even out).
struct Item {
  int qt, h, b, nk;
  __device__ Item(int i, int NH, int BH, int nqt)
      : qt(nqt - 1 - i / BH), h((i % BH) % NH), b((i % BH) / NH),
        nk(qt + 1) {}
};

__device__ __forceinline__ int item_of(int round) {
  const int G = static_cast<int>(gridDim.x), w = static_cast<int>(blockIdx.x);
  return round * G + ((round & 1) ? G - 1 - w : w);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 bf16* __restrict__ out, long long osb, long long osh,
                 long long ost, int NH, int BH, int T, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sq = base;                            // 128 q rows
  const uint32_t sk = base + TILE;                     // STAGES K tiles
  const uint32_t sv = base + (1 + STAGES) * TILE;      // STAGES V tiles
  const uint32_t so = base + (1 + 2 * STAGES) * TILE;  // output staging
  const Bars bars{base + (2 + 2 * STAGES) * TILE};
  const int nqt = T / BM, total = BH * nqt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
    mbar_init(bars.q_empty(), CONSUMERS * 4);      // a warp each
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), CONSUMERS * 4);
      mbar_init(bars.v_empty(s), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every load, running ahead into the
    // next item as the ring frees ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&mq);
      prefetch_map(&mk);
      prefetch_map(&mv);
      int it = 0;                    // ring tiles issued
      for (int r = 0, i; (i = item_of(r)) < total; ++r) {
        const Item w(i, NH, BH, nqt);
        mbar_wait(bars.q_empty(), (r & 1) ^ 1);   // passes on round 0
        mbar_expect_tx(bars.q_full(), TILE);
        tma_load(sq, &mq, bars.q_full(), 0, w.qt * BM, w.h, w.b);
        for (int j = 0; j < w.nk; ++j, ++it) {
          const int s = it % STAGES;
          const uint32_t free = ((it / STAGES) & 1) ^ 1;
          mbar_wait(bars.k_empty(s), free);
          mbar_expect_tx(bars.k_full(s), TILE);
          tma_load(sk + s * TILE, &mk, bars.k_full(s), 0, j * BN, w.h, w.b);
          mbar_wait(bars.v_empty(s), free);
          mbar_expect_tx(bars.v_full(s), TILE);
          tma_load(sv + s * TILE, &mv, bars.v_full(s), 0, j * BN, w.h, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;   // row in the query tile
    unsigned char* sow = smem + (so - base) + wg * 64 * 128;
    const uint32_t sqw = sq + wg * 64 * 128;  // this warpgroup's q rows
    const int me = BAR_TURN + wg, other = BAR_TURN + (wg ^ 1);

    float s[64], o[32];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
    // The turns run on across items: warpgroup 0 takes the first, each
    // turn passes to the other, and warpgroup 1 keeps its last. So neither
    // can arrive twice on the other's barrier before it has waited there.
    if (wg == 0) bar_arrive(me, 256);
    int it = 0;                      // ring tiles consumed
    for (int r = 0, i; (i = item_of(r)) < total; ++r) {
      const Item w(i, NH, BH, nqt);
      const bool last = item_of(r + 1) >= total;
#pragma unroll
      for (int c = 0; c < 32; ++c) o[c] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

      mbar_wait(bars.q_full(), r & 1);

      // tile 0: S alone
      int st = it % STAGES;
      mbar_wait(bars.k_full(st), (it / STAGES) & 1);
      bar_sync(me, 256);             // my turn
      wgmma_fence();
      fence_regs(s);
      issue_qk(s, sqw, sk + st * TILE);
      wgmma_commit();
      bar_arrive(other, 256);        // pass it on
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) {
        mbar_arrive(bars.k_empty(st));
        if (w.nk == 1) mbar_arrive(bars.q_empty());
      }
      if (w.qt == 0)
        softmax_tile<true>(s, m, l, alpha, r0, t, scale_log2);
      else
        softmax_tile<false>(s, m, l, alpha, r0, t, scale_log2);
      pack_p(p, s);

      for (int j = 1; j < w.nk; ++j) {
        const int sj = (it + j) % STAGES, si = (it + j - 1) % STAGES;
        mbar_wait(bars.k_full(sj), ((it + j) / STAGES) & 1);
        bar_sync(me, 256);             // my turn
        wgmma_fence();
        fence_regs(s);
        fence_regs(o);
        fence_regs(p);
        issue_qk(s, sqw, sk + sj * TILE);      // tile j's scores
        wgmma_commit();
        mbar_wait(bars.v_full(si), ((it + j - 1) / STAGES) & 1);
        issue_pv(o, p, sv + si * TILE);        // tile j - 1's values
        wgmma_commit();
        bar_arrive(other, 256);        // pass it on
        wgmma_wait<1>();                       // the scores are in
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(bars.k_empty(sj));
          if (j == w.nk - 1) mbar_arrive(bars.q_empty());  // q is done
        }
        if (j == w.qt)
          softmax_tile<true>(s, m, l, alpha, r0, t, scale_log2);
        else
          softmax_tile<false>(s, m, l, alpha, r0, t, scale_log2);
        wgmma_wait<0>();                       // so is p v
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(bars.v_empty(si));
#pragma unroll
        for (int c = 0; c < 32; ++c) o[c] *= alpha[(c >> 1) & 1];
        pack_p(p, s);
      }

      // the last tile's values
      st = (it + w.nk - 1) % STAGES;
      mbar_wait(bars.v_full(st), ((it + w.nk - 1) / STAGES) & 1);
      bar_sync(me, 256);             // my turn
      wgmma_fence();
      fence_regs(o);
      fence_regs(p);
      issue_pv(o, p, sv + st * TILE);
      wgmma_commit();
      if (wg == 0 || !last) bar_arrive(other, 256);  // the last: no taker
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bars.v_empty(st));
      it += w.nk;

      // normalize once, round to bf16, stage (16-byte chunk c of row r at
      // c ^ (r & 7), as the swizzle: free of bank conflicts), store 16
      // bytes a lane
      float inv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        l[c] += __shfl_xor_sync(0xffffffffu, l[c], 1);
        l[c] += __shfl_xor_sync(0xffffffffu, l[c], 2);
        inv[c] = 1.f / l[c];        // > 0: key 0 is below every row
      }
      bar_sync(BAR_EPI + wg, 128);  // the last item's stores have read
      const int ra = warp * 16 + g; // row in this warpgroup's 64 (and + 8)
#pragma unroll
      for (int n = 0; n < HS / 8; ++n) {
        const int off = ((n ^ (ra & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(sow + ra * 128 + off) =
            pack_bf16(o[4 * n] * inv[0], o[4 * n + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(sow + (ra + 8) * 128 + off) =
            pack_bf16(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
      }
      bar_sync(BAR_EPI + wg, 128);
      bf16* og = out + w.b * osb + w.h * osh +
                 (long long)(w.qt * BM + wg * 64) * ost;
#pragma unroll
      for (int k = 0; k < 64 * HS / 8 / 128; ++k) {
        const int c = tid + 128 * k;
        const int rr = c >> 3, ch = c & 7;
        *reinterpret_cast<int4*>(og + rr * ost + ch * 8) =
            *reinterpret_cast<const int4*>(sow + rr * 128 +
                                           ((ch ^ (rr & 7)) << 4));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (so the library needs no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of one operand from its geometry (ops/flash_attention.py::
// tensor_map_geometry, the one source of it): dims, byte strides and box,
// 128-byte swizzle. The driver refuses a stride TMA cannot read.
bool encode(CUtensorMap* map, EncodeTiled fn, const void* ptr,
            const long long* g) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(g[i]);
    box[i] = static_cast<cuuint32_t>(g[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(g[4 + i]);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v: bf16 (B, NH, T, hs) views; geom[0..32]: their tensor maps, 11
// values each (dims (hs, T, NH, B), byte strides of T, NH and B, box),
// q then k then v; geom[33..35]: out's element strides of B, NH and T (a
// bf16 view with its last dim contiguous). Returns cudaGetLastError()
// after the launch; a geometry the kernel does not read (hs != 64, T not
// a positive multiple of 128, B or NH < 1, k or v of other dims than q, a
// box other than one 128-row tile, a grid past 2^31 - 1 blocks), an
// unaligned pointer or a failed encoding returns cudaErrorInvalidValue
// without launching.
extern "C" int causal_attention_flash(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* geom, float sm_scale,
                                      void* stream) {
  const long long T = geom[1], NH = geom[2], B = geom[3];
  const long long bh = B * NH, blocks = T > 0 ? bh * (T / BM) : 0;
  bool ok = geom[0] == HS && T > 0 && T % T_ALIGN == 0 &&
            T <= 0x7fffffffLL && NH >= 1 &&
            B >= 1 && blocks <= 0x7fffffffLL &&
            ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) |
              reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  for (int m = 0; m < 3; ++m) {
    const long long* g = geom + 11 * m;
    for (int i = 0; i < 4; ++i) ok = ok && g[i] == geom[i];
    ok = ok && g[7] == HS && g[8] == BM && g[9] == 1 && g[10] == 1;
  }
  for (int i = 33; i < 36; ++i) ok = ok && geom[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  CUtensorMap mq, mk, mv;
  if (fn == nullptr || !encode(&mq, fn, q, geom) ||
      !encode(&mk, fn, k, geom + 11) || !encode(&mv, fn, v, geom + 22))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB of dynamic shared memory; the opt-in holds for the current
  // device only, so it is set on every launch
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int dev = 0, sms = 0;             // one persistent block a SM
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = blocks < sms ? blocks : sms;
  flash_fwd_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(out), geom[33], geom[34], geom[35],
      static_cast<int>(NH), static_cast<int>(bh), static_cast<int>(T),
      sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory a block takes (for the logs)
extern "C" int causal_attention_flash_smem_bytes() { return SMEM_BYTES; }

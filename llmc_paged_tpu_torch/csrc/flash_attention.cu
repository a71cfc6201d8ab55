// Causal flash attention over bf16 (B, NH, T, HS) for Hopper (sm_90a), on
// the tensor cores: the long-prompt prefill's attention.
//
// Replaces the TPU kernel that llmc_paged_tpu/ops/layers.py:86
// (causal_attention_flash) calls: JAX's bundled Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention with causal=True and
// sm_scale = 1/sqrt(HS), which prefill_attention takes for bf16 q with
// T >= 256 and T % 128 == 0. Entry causal_attention_flash of
// llmc_paged_tpu_torch/ops/flash_attention.py; its plain version,
// causal_attention_flash_ref, repeats the TPU kernel's arithmetic.
//
// Contract: out = softmax(q k^T * sm_scale, causal) v. q, k, v and out are
// bf16 (B, NH, T, 64), contiguous, 16-byte aligned; T % 128 == 0 (the TPU
// kernel's contract; the tiles here are 64); any B and NH (64-bit offsets).
// s = q k^T accumulates in f32 from the bf16 inputs and is scaled after the
// product; keys above the diagonal are masked; the softmax is online over
// key tiles with the running max and sum in f32; p = exp(s - m) rounds to
// bf16 before the p v product, which accumulates in f32; l sums the f32 p;
// the output rounds once to bf16. Key tiles wholly above the diagonal are
// skipped. What differs from the TPU kernel is the order of the f32
// sums: tiles of 64 keys (the TPU kernel takes 128), exp2 of a score
// pre-scaled by log2(e), and the accumulator normalized once at the end
// (the TPU kernel rescales it by 1/l every tile), so p's bf16 rounding
// falls at other points: within 2^-7 |plain| + 2e-3 of the plain version
// (chip_smoke.py phase 14).
//
// Bound on the H100 at the 124M long-context wave (B, NH, T) = (8, 12, 896):
// the bytes, q, k and v read once and out written once, 44.0 MB at
// 3.35 TB/s = 13.1 us; the causal products, 4 * HS * B * NH * T(T+1)/2 =
// 9.9 GFLOP at 989 TFLOP/s bf16, take 10.0 us. So bytes bound it, by a
// little: the design keeps every score in registers (the dense route
// writes and re-reads B * NH * T^2 of them, 154 MB at this shape) and puts
// both products on the tensor cores (on the CUDA cores the flops alone
// would take 150 us).
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
// one block of 4 warps a (b, h, query tile of 64 rows); a warp owns 16
// query rows. The q tile and a ring of two K and two V tiles of 64 keys sit
// in shared memory (rows padded to 144 bytes, so ldmatrix is free of bank
// conflicts; 45 KB in all): the next tile's cp.async copies overlap the
// current tile's products. Both products are mma.sync m16n8k16 bf16 -> f32
// (the conventions of int8_matmul.cu): q k^T takes q's A fragments
// (ldmatrix, once) against K's B fragments (ldmatrix: K rows are k^T's
// columns); p v takes p's A fragments straight from the score registers
// (the C layout of two n8 tiles is the A layout of one k16 step, so p never
// goes through shared memory) against V's B fragments (ldmatrix.trans).
// A lane holds two rows of scores; the row max and sum are taken over its
// quad by shuffles. Only the diagonal tile is masked. The 1-D grid lists
// the query tiles with the most key tiles first, so the causal imbalance
// leaves no tail of long blocks. The output tile goes through the warp's
// own rows of the q buffer and leaves in 16-byte stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;             // head size (every GPT-2 size)
constexpr int BM = 64;             // query rows a block, 16 a warp
constexpr int BN = 64;             // keys a tile
constexpr int WARPS = BM / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LD = HS + 8;         // shared row stride in bf16: 144 bytes
constexpr int T_ALIGN = 128;       // the TPU kernel's block: T % 128 == 0
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// a tile of 64 rows of HS bf16 (row stride HS in device memory) into
// shared rows of stride LD: 512 copies of 16 bytes, neighbouring threads
// on neighbouring addresses
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int tid) {
#pragma unroll
  for (int i = 0; i < 64 * HS / 8 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 3, col = (c & 7) * 8;
    cp_async16(s + r * LD + col, g + (size_t)r * HS + col);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int BH,
                 int T, float scale_log2) {
  __shared__ __align__(16) bf16 sq[BM * LD];
  __shared__ __align__(16) bf16 sk[2][BN * LD];
  __shared__ __align__(16) bf16 sv[2][BN * LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // most key tiles first: the last query tile of every (b, h), then the
  // one before it, ...
  const int qt = T / BM - 1 - static_cast<int>(blockIdx.x / BH);
  const size_t base = (size_t)(blockIdx.x % BH) * T * HS;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const int nk = qt + 1;           // key tiles at or below the diagonal

  load_tile(sq, q + base + (size_t)qt * BM * HS, tid);
  load_tile(sk[0], kg, tid);
  load_tile(sv[0], vg, tid);
  cp_commit();

  unsigned qf[HS / 16][4];         // q's A fragments, one a k16 step
  float acc[HS / 8][4];            // out, unnormalized: 8 n8 tiles of d
#pragma unroll
  for (int n = 0; n < HS / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (of the scores scaled
  // by log2 e) and this lane's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;  // row of the query tile (and + 8)

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {              // the next tile's copies in flight
      load_tile(sk[buf ^ 1], kg + (size_t)(j + 1) * BN * HS, tid);
      load_tile(sv[buf ^ 1], vg + (size_t)(j + 1) * BN * HS, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk)
        ldsm_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }

    // s = q k^T: 16 rows x 64 keys, 8 n8 tiles
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    const bf16* kt = sk[buf];
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        // matrices: keys +0..7 / +8..15 (lane bit 4) by d +0..7 / +8..15
        // (lane bit 3): b0, b1 of n8 tile 2np, then of 2np + 1
        unsigned b[4];
        ldsm_x4(b, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // scale (into the exp2 domain), mask the diagonal tile, row max over
    // the quad (element c of tile n: row g + 8 (c >> 1), key 8n + 2t +
    // (c & 1))
    const bool diag = j == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (diag && 8 * n + 2 * t + (c & 1) > row0 + 8 * (c >> 1))
          x = -INFINITY;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);     // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < HS / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];

    // p = exp2(s - m) in f32 for l, rounded to bf16 as the A fragments of
    // p v: k16 step kk is n8 tiles 2kk (a0, a1) and 2kk + 1 (a2, a3)
    unsigned pf[BN / 16][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // acc += p v: V's B fragments by ldmatrix.trans (matrices: keys
    // +0..7 / +8..15 (lane bit 3) by d +0..7 / +8..15 (lane bit 4))
    const bf16* vt = sv[buf];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < HS / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                         + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    __syncthreads();               // buf is free for tile j + 2's copies
  }

  // normalize once, round to bf16, stage in the warp's own q rows, and
  // store 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];           // > 0: key 0 is below every row
  }
  bf16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < HS / 8; ++n) {
    *reinterpret_cast<unsigned*>(so + g * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<unsigned*>(so + (g + 8) * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* og = out + base + ((size_t)qt * BM + warp * 16) * HS;
#pragma unroll
  for (int i = 0; i < 16 * HS / 8 / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<int4*>(og + (size_t)r * HS + col) =
        *reinterpret_cast<const int4*>(so + r * LD + col);
  }
}

}  // namespace

// q, k, v, out: bf16 (B, NH, T, hs), contiguous, 16-byte aligned. Returns
// cudaGetLastError() after the launch; a shape the kernel does not take
// (hs != 64, T not a positive multiple of 128, B or NH < 1, a grid past
// 2^31 - 1 blocks) or an unaligned pointer returns cudaErrorInvalidValue
// without launching.
extern "C" int causal_attention_flash(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int NH, int T, int hs, float sm_scale,
                                      void* stream) {
  const long long bh = (long long)B * NH;
  const long long blocks = bh * (T / BM);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (hs != HS || T <= 0 || T % T_ALIGN != 0 || B < 1 || NH < 1 ||
      blocks > 0x7fffffffLL || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<int>(bh), T, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

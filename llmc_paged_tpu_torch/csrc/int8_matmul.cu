// Fused dequant matmul over int8 weights (W8A16 / W8A32), for Hopper
// (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel _int8_matmul_kernel of llmc_paged_tpu/ops/int8.py
// (line 75; pallas_call at :253 and :263, wrapper int8_matmul at :215), entry
// int8_matmul of llmc_paged_tpu_torch/ops/int8.py. It serves the kernel lab
// (ops/dev/bench_int8_matmul.py); the serving int8 linear stays a plain
// product, as it is in the JAX package.
//
// Contract: out[b, oc] = scale[oc] * sum_ic x[b, ic] * wq[oc, ic], f32.
// x (B, IC) f32 or bf16, wq (OC, IC) int8, scale (OC,) f32, out (B, OC) f32,
// all contiguous; any B, OC, IC >= 1. With bf16_compute, x rounds to bf16
// once (to nearest even, as torch's .to(bfloat16)) before the multiply: an
// int8 value times a bf16 value is exact in f32, so only the f32 sums round.
// Without it the products are f32 products. The scale multiplies the sum
// once, at the end.
//
// Bound on the H100: at decode rows (B <= 8) the weight bytes, OC*IC at
// 3.35 TB/s: (8, 2304, 768) 0.53 us, (8, 51200, 768) 11.7 us. At prefill
// rows (256, 3072, 768): in bf16 mode the bytes (x, weights and out once:
// 6.3 MB, 1.88 us; the products, 2*B*OC*IC at 989 TFLOP/s, take 1.22 us),
// in fp32 mode the tensor cores (three bf16 products, below: 3.66 us).
//
// Both modes on the tensor cores, with every product unchanged: an int8
// weight is exact in bf16 (8 significant bits) and a product of two bf16
// values is exact in f32, so the bf16 mode is mma.sync m16n8k16 bf16 x bf16
// -> f32 as it stands. The fp32 mode splits each f32 x into three bf16
// terms by truncation, hi = top 16 bits of x, mid = top 16 bits of x - hi,
// lo = x - hi - mid (8 + 8 + 8 significant bits, so hi + mid + lo = x
// exactly wherever x's lowest bit lies on the bf16 grid, |x| >= 2^-110; below
// that the error is under 2^-133), and runs three MMAs (lo, mid, hi) against
// the same weight fragments. Truncation, not rounding: the largest f32
// rounds to infinity in bf16. ops/int8.py::split_bf16x3 is the plain mirror.
// The tensor cores sum inside an MMA with truncation, which drifts over a
// long chain, so each 64-column step sums into fresh registers that are
// added to the running f32 sums with ordinary (rounded) adds.
//
// Design. mma.sync, not wgmma: at decode rows the weight bytes bound the
// kernel and one n8 tile holds every row, which wgmma's 64-row tiles would
// waste (wgmma was not tried). A warp computes a tile of 16*MT output
// channels by 8*NT rows of x (A = 16 channels x 16 columns of wq, B = 16
// columns x 8 rows of x) over a share of IC, in 64-column steps. Inside a
// step the column order does not matter to the sum, so it is permuted such
// that the 16 bytes lane (g, t) = (lane / 4, lane % 4) loads from channel g
// (and g + 8), columns 16t..16t+15, are exactly its A fragments of the
// step's four k16 tiles: byte 4j + e is k16 tile j, logical column
// 2t + (e & 1) + 8 (e >> 1). The B fragment of tile j, row g, then holds x
// columns 16t + 4j .. 16t + 4j + 3: one float4 (f32 x) or 8 bytes (bf16 x),
// no shuffle. An int8 word becomes two bf16 pairs by a byte permute into
// the mantissa of 2^23, one exact subtraction a value and a permute of the
// upper halves (exact: integers of at most 8 significant bits), not by the
// quarter-rate integer-to-float unit. Each lane streams its weights in
// 16-byte vectors, the next step's in flight while the current one
// multiplies (4 loads at MT = 1, 8 at MT = 2).
// The blocks are persistent (as many as fit the card at once) and walk
// channel tiles; a block's W warps split IC's 64-column steps round robin
// (W the fewest warps that take the same number of rounds as the most
// allowed) and merge their sums through shared memory in a fixed order
// after each tile: no atomics, no second launch, deterministic. The
// launcher picks the shape of the work from B, OC and IC only:
//   * decode rows (B <= 8): NT = 1, one n8 tile covers every row, so each
//     weight byte is read once; up to 8 warps a block. MT = 2 where OC gives
//     at least two blocks an SM at 32 channels (the lm_head) and the x
//     fragments of a block's steps fit in 112 KB: each lane makes them once
//     and keeps them in shared memory for all the block's tiles. Else MT = 1
//     (16-channel tiles, so that (8, 2304, 768) makes 144) and each step
//     loads and converts its x.
//   * prefill rows (B > 8): MT = 2, NT = 4, tiles of 32 channels by 32 rows,
//     up to 4 warps a block; each weight is re-read from L2 once per 32
//     rows and x once per 32 channels, which bounds this case (the x bytes
//     are four times the weight bytes).
// Tried and dropped (PERF.md §6): weights two or three steps ahead,
// weight loads that skip L1, x loaded with the weights, a bf16 subtraction
// in place of the f32 one, and a prefill kernel whose warps share each
// step's x fragments through shared memory (128 x 64 tiles: faster at
// (256, 3072, 768) in bf16 mode, slower where OC or B gives fewer blocks
// than SMs).
// Where IC % 16 != 0, or x or wq is not 16-byte aligned, the rows are not
// 16-byte aligned and a scalar kernel on the CUDA cores (the first design)
// reads them one value at a time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int STEP = 64;            // columns a warp takes a step
constexpr int MAX_ROW_TILES = 65535;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// ---- the tensor-core kernel --------------------------------------------------

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the upper halves of two f32 (bf16 by truncation) as one bf16 pair, lo
// in the low half
__device__ __forceinline__ unsigned top_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the 4 int8 values of a 32-bit word as two bf16 pairs (bytes 0,1 and
// 2,3), exactly: bias each byte to unsigned (b ^ 0x80 = b + 128), place it
// in the low mantissa bits of 2^23 and subtract 2^23 + 128; an integer of
// at most 8 significant bits is its f32's upper half
__device__ __forceinline__ void word_bf16(int word, unsigned& b01,
                                          unsigned& b23) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
  constexpr float BIAS = 8388608.f + 128.f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - BIAS;
  b01 = top_pair(f0, f1);
  b23 = top_pair(f2, f3);
}

__device__ __forceinline__ int word_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// x - (x truncated to bf16): exact in f32
__device__ __forceinline__ float rest(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// The B fragments (TERMS of them: hi, mid, lo) of 4 consecutive x values
// p[0..3] (zeros where !ok): the pairs (p0, p1) and (p2, p3).
template <typename XT, bool BF16, int TERMS>
__device__ __forceinline__ void x_frag(const XT* p, bool ok,
                                       unsigned (&b)[TERMS][2]) {
  if constexpr (sizeof(XT) == 2) {        // bf16 x: the bits themselves
    const uint2 u = ok ? __ldg(reinterpret_cast<const uint2*>(p))
                       : make_uint2(0u, 0u);
    b[0][0] = u.x;
    b[0][1] = u.y;
  } else {
    const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (BF16) {                  // round to nearest even, once
      const __nv_bfloat162 p01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 p23 = __floats2bfloat162_rn(v.z, v.w);
      b[0][0] = *reinterpret_cast<const unsigned*>(&p01);
      b[0][1] = *reinterpret_cast<const unsigned*>(&p23);
    } else {                               // hi + mid + lo = x
      const float r0 = rest(v.x), r1 = rest(v.y), r2 = rest(v.z),
                  r3 = rest(v.w);
      b[0][0] = top_pair(v.x, v.y);
      b[0][1] = top_pair(v.z, v.w);
      b[1][0] = top_pair(r0, r1);
      b[1][1] = top_pair(r2, r3);
      b[2][0] = top_pair(rest(r0), rest(r1));
      b[2][1] = top_pair(rest(r2), rest(r3));
    }
  }
}

// The next step a warp loads: round r of tile `tile`, then round r + 1,
// or round 0 of the block's next tile.
struct Cursor {
  int tile, r;
  __device__ __forceinline__ void advance(int rounds) {
    if (++r == rounds) {
      r = 0;
      tile += gridDim.x;
    }
  }
};

// lane (g, t)'s 16-byte weight vectors of one step: channels
// oc0 + 16m + 8h + g, columns col + 16t .. col + 16t + 15 (zeros past OC
// or IC)
template <int MT>
__device__ __forceinline__ void load_w(int4 (&v)[MT][2],
                                       const int8_t* __restrict__ wq, int OC,
                                       int IC, int oc0, int col, int g,
                                       int t) {
  const bool in = col + 16 * t < IC;     // IC % 16 == 0: whole vectors
  const int8_t* p = wq + (size_t)(oc0 + g) * IC + col + 16 * t;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      v[m][h] = in && oc0 + 16 * m + 8 * h + g < OC
                    ? __ldg(reinterpret_cast<const int4*>(
                          p + (size_t)(16 * m + 8 * h) * IC))
                    : make_int4(0, 0, 0, 0);
}

// XS: the x fragments of a warp's steps are made once, before the first
// tile, and kept in shared memory (each lane reads back its own), for
// decode rows where they fit; otherwise each step loads and converts them.
template <typename XT, bool BF16, int MT, int NT, bool XS>
__global__ void __launch_bounds__(256)
int8_mma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, float* __restrict__ out,
                int B, int OC, int IC) {
  constexpr int TERMS = (BF16 || sizeof(XT) == 2) ? 1 : 3;
  constexpr int NACC = MT * NT * 4;        // f32 sums a lane
  static_assert(!XS || NT == 1, "x staged for one n8 tile");
  // [W][NACC][32] f32 sums, then with XS [W][rounds][4][TERMS][32] pairs
  extern __shared__ __align__(16) float red[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * 8 * NT;
  const int ntiles = (OC + 16 * MT - 1) / (16 * MT);
  const int nsteps = (IC + STEP - 1) / STEP;
  const int rounds = (nsteps - warp + W - 1) / W;   // >= 1: W <= nsteps

  const XT* xrow[NT];
  bool xok[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int r = r0 + 8 * n + g;
    xok[n] = r < B;
    xrow[n] = x + (size_t)min(r, B - 1) * IC + 16 * t;
  }

  // the block walks channel tiles blockIdx.x, + gridDim.x, ...; a warp
  // takes steps warp, warp + W, ... of each, the next step's weights (the
  // next tile's first at the end of a tile) in flight while it multiplies
  Cursor ld{static_cast<int>(blockIdx.x), 0};
  int4 cur[MT][2];
  if (ld.tile < ntiles)
    load_w<MT>(cur, wq, OC, IC, ld.tile * 16 * MT, warp * STEP, g, t);
  ld.advance(rounds);

  uint2* xs = reinterpret_cast<uint2*>(red + (size_t)W * NACC * 32) +
              (size_t)warp * ((nsteps + W - 1) / W) * 4 * TERMS * 32 + lane;
  if constexpr (XS) {
    for (int r = 0; r < rounds; ++r) {
      const int col = (warp + r * W) * STEP;
      const bool in = col + 16 * t < IC;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned b[TERMS][2];
        x_frag<XT, BF16, TERMS>(xrow[0] + col + 4 * j, in && xok[0], b);
#pragma unroll
        for (int e = 0; e < TERMS; ++e)
          xs[((r * 4 + j) * TERMS + e) * 32] = make_uint2(b[e][0], b[e][1]);
      }
    }
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int oc0 = tile * 16 * MT;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;

    for (int r = 0; r < rounds; ++r) {
      const int col = (warp + r * W) * STEP;
      int4 nxt[MT][2];
      const bool more = ld.tile < ntiles;
      if (more)
        load_w<MT>(nxt, wq, OC, IC, ld.tile * 16 * MT,
                   (warp + ld.r * W) * STEP, g, t);
      ld.advance(rounds);

      const bool in = col + 16 * t < IC;
      float part[MT][NT][4];               // this step's sums, fresh
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[m][n][c] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {        // the step's four k16 tiles
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          word_bf16(word_of(cur[m][0], j), a[m][0], a[m][2]);
          word_bf16(word_of(cur[m][1], j), a[m][1], a[m][3]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          unsigned b[TERMS][2];
          if constexpr (XS) {
#pragma unroll
            for (int e = 0; e < TERMS; ++e) {
              const uint2 v = xs[((r * 4 + j) * TERMS + e) * 32];
              b[e][0] = v.x;
              b[e][1] = v.y;
            }
          } else {
            x_frag<XT, BF16, TERMS>(xrow[n] + col + 4 * j, in && xok[n], b);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = TERMS - 1; e >= 0; --e)   // lo, mid, hi
              mma_bf16(part[m][n], a[m], b[e][0], b[e][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][n][c] += part[m][n][c];
      if (more) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          cur[m][0] = nxt[m][0];
          cur[m][1] = nxt[m][1];
        }
      }
    }

    // the warps' sums through shared memory, added in warp order
    float* mine = red + (size_t)warp * NACC * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mine[((m * NT + n) * 4 + c) * 32 + lane] = acc[m][n][c];
    __syncthreads();
    for (int e = threadIdx.x; e < NACC * 32; e += blockDim.x) {
      float v = red[e];
      for (int w = 1; w < W; ++w) v += red[(size_t)w * NACC * 32 + e];
      const int i = e >> 5, l = e & 31, c = i & 3;
      const int m = i / (NT * 4), n = (i >> 2) % NT;
      // sum c of lane l: channel l/4 (+8 for c >= 2), row 2(l%4) + c%2
      const int oc = oc0 + 16 * m + (l >> 2) + 8 * (c >> 1);
      const int r = r0 + 8 * n + 2 * (l & 3) + (c & 1);
      if (oc < OC && r < B) out[(size_t)r * OC + oc] = v * scale[oc];
    }
    __syncthreads();                       // red is free for the next tile
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  return sms;
}

// shared memory the x fragments of XS take, a block
constexpr size_t XS_MAX = 112 * 1024;

template <typename XT, bool BF16, int MT, int NT, bool XS>
cudaError_t launch_mma(int warps, const void* x, const void* wq,
                       const void* scale, void* out, int B, int OC, int IC,
                       size_t xs_bytes, cudaStream_t stream) {
  const int row_tiles = (B + 8 * NT - 1) / (8 * NT);
  if (row_tiles > MAX_ROW_TILES) return cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * MT * NT * 4 * 32 * sizeof(float) +
                      (XS ? xs_bytes : 0);
  auto kern = int8_mma_kernel<XT, BF16, MT, NT, XS>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: as many as fit the card at once, none in a later wave
  int resident = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kern, warps * 32, smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (OC + 16 * MT - 1) / (16 * MT);
  const int per_row =
      (std::max(resident, 1) * num_sms() + row_tiles - 1) / row_tiles;
  const dim3 grid(std::min(ntiles, per_row), row_tiles);
  kern<<<grid, warps * 32, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), B, OC, IC);
  return cudaGetLastError();
}

// decode rows: one n8 tile; 32-channel tiles with x staged where OC still
// makes two blocks an SM and the x fragments fit, else 16-channel tiles
template <typename XT, bool BF16>
cudaError_t launch_decode(int warps, const void* x, const void* wq,
                          const void* scale, void* out, int B, int OC, int IC,
                          cudaStream_t stream) {
  constexpr int TERMS = (BF16 || sizeof(XT) == 2) ? 1 : 3;
  const int nsteps = (IC + STEP - 1) / STEP;
  const size_t xs_bytes = (size_t)warps * ((nsteps + warps - 1) / warps) *
                          4 * TERMS * 32 * sizeof(uint2);
  if (OC >= 32 * 2 * num_sms() && xs_bytes <= XS_MAX)
    return launch_mma<XT, BF16, 2, 1, true>(warps, x, wq, scale, out, B, OC,
                                            IC, xs_bytes, stream);
  return launch_mma<XT, BF16, 1, 1, false>(warps, x, wq, scale, out, B, OC,
                                           IC, 0, stream);
}

// ---- the scalar kernel (rows not 16-byte aligned) ------------------------------

// The first design, on the CUDA cores: a tile is OCT = 32 output channels
// (4 a warp of 8 warps) by RT = 8 rows; a block stages its rows of x in
// shared memory as f32 (rounded through bf16 with bf16_compute), ICC
// columns at a time, the lanes read wq one value at a time and keep 4 x 8
// sums, reduced over the warp at the end of a tile. Blocks are persistent,
// about two a streaming multiprocessor.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int OPW = 4;             // output channels a warp
constexpr int OCT = WARPS * OPW;   // output channels a tile
constexpr int RT = 8;              // rows a tile
constexpr int ICC = 2048;          // x columns staged a chunk

__device__ __forceinline__ float to_x(float v) { return v; }
__device__ __forceinline__ float to_x(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool BF16>
__device__ __forceinline__ float round_x(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// one step of the warp's halving reduction of 32 sums: a lane keeps the
// half v[0..S) or v[S..2S) that its lane bit S picks, in v[0..S), and adds
// its partner's (lane ^ S) copy of that half
template <int S>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float keep = upper ? v[i + S] : v[i];
    const float send = upper ? v[i] : v[i + S];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

template <typename XT, bool BF16>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
int8_scalar_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int B, int OC, int IC) {
  extern __shared__ __align__(16) float xs[];   // RT rows of min(IC, ICC)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, B - r0);
  const int ntiles = (OC + OCT - 1) / OCT;
  const int row = min(IC, ICC);
  const bool once = IC <= ICC;     // x staged once for all the block's tiles

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int oc0 = tile * OCT + warp * OPW;
    float acc[OPW][RT];
#pragma unroll
    for (int o = 0; o < OPW; ++o)
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[o][r] = 0.f;

    for (int c = 0; c < IC; c += ICC) {
      const int n = min(ICC, IC - c);
      if (!once || tile == static_cast<int>(blockIdx.x)) {
        __syncthreads();                  // the previous chunk is consumed
        for (int e = threadIdx.x; e < RT * n; e += THREADS) {
          const int r = e / n, i = e - r * n;
          xs[r * row + i] =
              r < nr ? round_x<BF16>(to_x(x[(size_t)(r0 + r) * IC + c + i]))
                     : 0.f;
        }
        __syncthreads();
      }
      for (int i = lane; i < n; i += 32) {
        float w[OPW];
#pragma unroll
        for (int o = 0; o < OPW; ++o)
          w[o] = oc0 + o < OC
                     ? static_cast<float>(wq[(size_t)(oc0 + o) * IC + c + i])
                     : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float xv = xs[r * row + i];
#pragma unroll
          for (int o = 0; o < OPW; ++o) acc[o][r] += w[o] * xv;
        }
      }
    }

    // the warp's 32 sums over its lanes, by halving: lane l ends with sum
    // o*RT + r = l
    static_assert(OPW * RT == 32, "one sum a lane");
    float v[32];
#pragma unroll
    for (int o = 0; o < OPW; ++o)
#pragma unroll
      for (int r = 0; r < RT; ++r) v[o * RT + r] = acc[o][r];
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    const int oc = oc0 + lane / RT, r = lane % RT;
    if (oc < OC && r < nr)
      out[(size_t)(r0 + r) * OC + oc] = v[0] * scale[oc];
  }
}

template <typename XT, bool BF16>
cudaError_t launch_scalar(const void* x, const void* wq, const void* scale,
                          void* out, int B, int OC, int IC,
                          cudaStream_t stream) {
  const int row_tiles = (B + RT - 1) / RT;
  if (row_tiles > MAX_ROW_TILES) return cudaErrorInvalidValue;
  const int ntiles = (OC + OCT - 1) / OCT;
  // about BLOCKS_PER_SM blocks a streaming multiprocessor in all
  const int per_row = (num_sms() * BLOCKS_PER_SM + row_tiles - 1) / row_tiles;
  const dim3 grid(std::min(ntiles, per_row), row_tiles);
  const size_t smem = (size_t)RT * std::min(IC, ICC) * sizeof(float);
  auto kern = int8_scalar_kernel<XT, BF16>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), B, OC, IC);
  return cudaGetLastError();
}

template <typename XT, bool BF16>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, int B, int OC, int IC, cudaStream_t stream) {
  if (B < 1 || OC < 1 || IC < 1) return cudaErrorInvalidValue;
  const bool vec = IC % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!vec)
    return launch_scalar<XT, BF16>(x, wq, scale, out, B, OC, IC, stream);
  // the fewest warps a block (at most 4 at prefill rows, 8 at decode rows)
  // that split IC's steps in as few rounds as the most would
  const int most = B > 8 ? 4 : 8;
  const int nsteps = (IC + STEP - 1) / STEP;
  const int rounds = (nsteps + most - 1) / most;
  const int warps = (nsteps + rounds - 1) / rounds;
  if (B > 8)   // prefill rows: 32 x 32 tiles
    return launch_mma<XT, BF16, 2, 4, false>(warps, x, wq, scale, out, B, OC,
                                             IC, 0, stream);
  return launch_decode<XT, BF16>(warps, x, wq, scale, out, B, OC, IC, stream);
}

}  // namespace

// x kinds, shared with the Python wrapper (ops/int8.py).
enum { KIND_F32 = 0, KIND_BF16 = 1 };

// x_kind: KIND_F32 | KIND_BF16; bf16_compute: 0 | 1. Returns
// cudaGetLastError() after the launch; an unsupported kind or shape returns
// cudaErrorInvalidValue without launching.
extern "C" int int8_matmul(int x_kind, int bf16_compute, const void* x,
                           const void* wq, const void* scale, void* out,
                           int B, int OC, int IC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == KIND_F32)
    return static_cast<int>(
        bf16_compute ? launch<float, true>(x, wq, scale, out, B, OC, IC, s)
                     : launch<float, false>(x, wq, scale, out, B, OC, IC, s));
  if (x_kind == KIND_BF16)
    return static_cast<int>(
        bf16_compute
            ? launch<__nv_bfloat16, true>(x, wq, scale, out, B, OC, IC, s)
            : launch<__nv_bfloat16, false>(x, wq, scale, out, B, OC, IC, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

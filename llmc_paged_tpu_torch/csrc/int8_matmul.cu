// Fused dequant matmul over int8 weights (W8A16 / W8A32), for Hopper
// (sm_90a).
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
// Bound on the H100: at decode rows (B = 8) the weight bytes, OC*IC at
// 3.35 TB/s: (8, 2304, 768) 0.53 us, (8, 51200, 768) 11.7 us. At prefill rows
// the operations, 2*B*OC*IC at 67 TFLOP/s on the CUDA cores (fp32) or at
// 989 TFLOP/s on the tensor cores (bf16): (256, 3072, 768) 18 us in f32.
// At B = 8 an f32 product needs 16 operations a weight byte, 54 TFLOP/s at
// the memory's rate: the CUDA cores are nearly the limit as well.
//
// Design: a weight-streaming GEMV/GEMM on the CUDA cores. A tile is
// OCT = 32 output channels (4 a warp of 8 warps) by RT = 8 rows, so decode
// at B <= 8 reads every weight byte once (a larger B re-reads a tile's
// weights from L2 once per 8 rows). The blocks are persistent: about two a
// streaming multiprocessor, each walking tiles blockIdx.x, + gridDim.x, ...
// of its 8 rows. A block stages its rows of x in shared memory as f32
// (rounded through bf16 with bf16_compute), in chunks of ICC = 2048 columns
// (80 KB, opted in), padded to 20 floats per 16 columns so that the 16-byte
// reads of the 8 lanes of a quarter warp fall in distinct banks; where
// IC <= ICC (every GPT-2 width but 1.5B's 6400) it stages x once for all its
// tiles, 16 bytes a thread. Each lane reads wq in 16-byte vectors (16 int8
// of one channel; a warp reads 512 contiguous bytes of a channel's row),
// issuing the next vector's 4 loads before it multiplies the current one
// against the 8 staged rows; it keeps 4 x 8 sums in f32 registers, which the
// warp reduces at the end of a tile in 31 shuffles (halving: each lane ends
// with one of the 32 sums) before applying scale[oc]. The int8 values
// become f32 through a byte permute and a subtraction, not the quarter-rate
// integer-to-float unit. Where IC % 16 != 0 (or x or wq is not 16-byte
// aligned) the rows are not 16-byte aligned, and the lanes read them one
// value at a time.
// mma.sync/wgmma tiles for prefill rows are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int OPW = 4;             // output channels a warp
constexpr int OCT = WARPS * OPW;   // output channels a tile
constexpr int RT = 8;              // rows a tile
constexpr int ICC = 2048;          // x columns staged a chunk
constexpr int VEC = 16;            // int8 values in a 16-byte vector
constexpr int PAD = 20;            // floats one staged 16-column group takes
constexpr int MAX_ROW_TILES = 65535;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

// where column i of a staged chunk lives in its row of shared memory
__device__ __forceinline__ int xs_idx(int i) {
  return (i >> 4) * PAD + (i & 15);
}

__device__ __forceinline__ float to_x(float v) { return v; }
__device__ __forceinline__ float to_x(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool BF16>
__device__ __forceinline__ float round_x(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

// the 4 int8 values of a 32-bit word as f32, exactly, without the
// quarter-rate integer-to-float unit: bias each byte to unsigned (b ^ 0x80
// = b + 128), place it in the low mantissa bits of 2^23 (0x4B0000bb) and
// subtract 2^23 + 128
__device__ __forceinline__ void bytes_f32(int word, float (&f)[4]) {
  const unsigned u = static_cast<unsigned>(word) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ int word_of(const int4& v, int g) {
  return g == 0 ? v.x : g == 1 ? v.y : g == 2 ? v.z : v.w;
}

// x[r0 : r0+RT, c : c+n] into xs (rows of `row` floats; rows past B zero)
template <typename XT, bool BF16, bool VECTOR>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x, float* xs,
                                        int row, int r0, int nr, int IC,
                                        int c, int n) {
  if constexpr (VECTOR && sizeof(XT) == 4) {   // f32 x, 16-byte aligned
    const int n4 = n / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < RT * n4; e += THREADS) {
      const int r = e / n4, i = (e - r * n4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < nr) {
        v = __ldg(reinterpret_cast<const float4*>(
            x + (size_t)(r0 + r) * IC + c + i));
        v = make_float4(round_x<BF16>(v.x), round_x<BF16>(v.y),
                        round_x<BF16>(v.z), round_x<BF16>(v.w));
      }
      *reinterpret_cast<float4*>(&xs[r * row + xs_idx(i)]) = v;
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < RT * n; e += THREADS) {
      const int r = e / n, i = e - r * n;
      xs[r * row + xs_idx(i)] =
          r < nr ? round_x<BF16>(to_x(x[(size_t)(r0 + r) * IC + c + i]))
                 : 0.f;
    }
  }
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

// the 16-byte vectors at column col of this warp's OPW channels
__device__ __forceinline__ void load_w(int4 (&raw)[OPW],
                                       const int8_t* __restrict__ wq, int oc0,
                                       int OC, int IC, int col) {
#pragma unroll
  for (int o = 0; o < OPW; ++o)
    raw[o] = oc0 + o < OC ? __ldg(reinterpret_cast<const int4*>(
                                wq + (size_t)(oc0 + o) * IC + col))
                          : make_int4(0, 0, 0, 0);
}

template <typename XT, bool BF16, bool VECTOR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int B, int OC, int IC, int row) {
  extern __shared__ __align__(16) float xs[];   // RT rows of `row` floats

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * RT;
  const int nr = min(RT, B - r0);
  const int ntiles = (OC + OCT - 1) / OCT;
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
        stage_x<XT, BF16, VECTOR>(x, xs, row, r0, nr, IC, c, n);
        __syncthreads();
      }
      if (VECTOR) {                       // n % 16 == 0 here
        const int nv = n / VEC;
        int4 raw[OPW];
        if (lane < nv) load_w(raw, wq, oc0, OC, IC, c + lane * VEC);
        for (int v = lane; v < nv; v += 32) {
          int4 nxt[OPW];
          const bool more = v + 32 < nv;
          if (more) load_w(nxt, wq, oc0, OC, IC, c + (v + 32) * VEC);
#pragma unroll
          for (int g = 0; g < 4; ++g) {   // 4 columns at a time
            float w[OPW][4];
#pragma unroll
            for (int o = 0; o < OPW; ++o) bytes_f32(word_of(raw[o], g), w[o]);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float4 xv = *reinterpret_cast<const float4*>(
                  &xs[r * row + v * PAD + 4 * g]);
#pragma unroll
              for (int o = 0; o < OPW; ++o) {
                float a = acc[o][r];
                a += w[o][0] * xv.x;
                a += w[o][1] * xv.y;
                a += w[o][2] * xv.z;
                a += w[o][3] * xv.w;
                acc[o][r] = a;
              }
            }
          }
          if (more) {
#pragma unroll
            for (int o = 0; o < OPW; ++o) raw[o] = nxt[o];
          }
        }
      } else {
        for (int i = lane; i < n; i += 32) {
          float w[OPW];
#pragma unroll
          for (int o = 0; o < OPW; ++o)
            w[o] = oc0 + o < OC
                       ? static_cast<float>(wq[(size_t)(oc0 + o) * IC + c + i])
                       : 0.f;
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float xv = xs[r * row + xs_idx(i)];
#pragma unroll
            for (int o = 0; o < OPW; ++o) acc[o][r] += w[o] * xv;
          }
        }
      }
    }

    // the warp's 32 sums over its lanes, by halving: at each step a lane
    // keeps the half of its sums that its lane bit picks and adds its
    // partner's copy of that half; lane l ends with sum o*RT + r = l
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

template <typename XT, bool BF16, bool VECTOR>
cudaError_t launch_kernel(dim3 grid, size_t smem, const void* x,
                          const void* wq, const void* scale, void* out, int B,
                          int OC, int IC, int row, cudaStream_t stream) {
  auto kern = int8_matmul_kernel<XT, BF16, VECTOR>;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(out), B, OC, IC,
      row);
  return cudaGetLastError();
}

template <typename XT, bool BF16>
cudaError_t launch(const void* x, const void* wq, const void* scale,
                   void* out, int B, int OC, int IC, cudaStream_t stream) {
  const int row_tiles = (B + RT - 1) / RT;
  if (B < 1 || OC < 1 || IC < 1 || row_tiles > MAX_ROW_TILES)
    return cudaErrorInvalidValue;
  const int ntiles = (OC + OCT - 1) / OCT;
  // about BLOCKS_PER_SM blocks a streaming multiprocessor in all
  const int per_row = (num_sms() * BLOCKS_PER_SM + row_tiles - 1) / row_tiles;
  dim3 grid(std::min(ntiles, per_row), row_tiles);
  const int row = (std::min(IC, ICC) + VEC - 1) / VEC * PAD;
  const size_t smem = (size_t)RT * row * sizeof(float);
  const bool vec = IC % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    return launch_kernel<XT, BF16, true>(grid, smem, x, wq, scale, out, B, OC,
                                         IC, row, stream);
  return launch_kernel<XT, BF16, false>(grid, smem, x, wq, scale, out, B, OC,
                                        IC, row, stream);
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

// Softmax over whole vocab rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel _softmax_kernel of
// llmc_paged_tpu/ops/dev/bench_softmax.py (line 27; pallas_call at :40 in
// pallas_softmax_rows), entry softmax_rows of
// llmc_paged_tpu_torch/ops/dev/bench_softmax.py (the kernel lab).
//
// Contract: out[b, :] = exp(x[b, :] - m) / sum exp(x[b, :] - m), m the row's
// max, computed in f32 and rounded to x's dtype once. x (B, V) f32 or bf16,
// out (B, V) in x's dtype, contiguous; V * 4 bytes (plus 128) within the
// 227 KB of shared memory a block may opt in to (V <= 58,080).
//
// Bound on the H100: bytes, 2*B*V*itemsize at 3.35 TB/s: (8, 50304) f32
// 0.96 us; (64, 50304) 7.69 us; (8, 51200) 0.98 us.
//
// Design: one row split over a thread-block cluster of c blocks (c a power
// of two up to 16; the wrapper's rule, ops/dev/bench_softmax.py::
// cluster_size, picks the smallest with B * c >= the SMs, at most 8, halved
// while the card cannot hold such a cluster). A 1-D grid of B * c blocks of
// 256 threads, cluster dims (c, 1, 1): the c blocks of a cluster share one
// row, each a contiguous slice of about V / c columns. Each block:
//   1. reads its slice once, 16-byte vectors (4 f32 or 8 bf16), 4 vectors
//      a thread in flight, into dynamic shared memory as f32, keeping each
//      thread's max; the row's scalar head up to the first 16-byte boundary
//      (rows of odd bf16 V or f32 V % 4 != 0 start unaligned for b >= 1)
//      goes to rank 0, its tail to rank c - 1, never read across the row's
//      edge;
//   2. reduces the max over its warps and pushes it into slot [rank] of
//      every block of the cluster: a remote store into distributed shared
//      memory (st.async) that completes the receiver's mbarrier; each block
//      waits on its own mbarrier for the c maxima: the row max m;
//   3. computes exp(x - m) in place with that one m (never exp(x - m_local)
//      * exp(m_local - m), which rounds twice), sums it, and pushes the sum
//      the same way (a second mbarrier); each block adds the c sums in rank
//      order, so every block divides by the same s;
//   4. writes its slice once as e / s (a true division, then one rounding).
// The mbarriers are initialized before the load and made visible to the
// cluster by one barrier whose arrive comes before the load and whose wait
// comes after it, so that its latency hides behind the load. Each block
// only writes into the others' shared memory and waits for all c values it
// is sent before it goes on, so no block exits while a store into it is in
// flight and no further barrier is needed. A block whose slice is empty
// (V < c vectors) contributes max -inf and sum 0. At c = 1 (B >= the SM
// count) the exchange is skipped and the block is the whole row. An x and
// out that are not equally aligned modulo 16 bytes take the scalar
// instance (one element a unit, the same passes).
//
// Tried and dropped (PERF.md §6): the exchange as a remote store then
// cluster.sync() (about 0.85 us an exchange at (8, 64)); one exchange of
// (block max, block sum of exp(x - block max)) pairs, rescaled on arrival;
// 512 and 128 threads; 8 loads in flight a thread; each warp pushing its
// own max and sum; c = 16 at B = 8 (slower than c = 8, so the rule stops
// at 8). The previous design, one block of 1024 threads a row with scalar
// accesses, took 11.85 us at (8, 50304) f32 with 8 of the 132 SMs working.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                  // vector loads in flight a thread
constexpr int MAX_CLUSTER = 16;            // non-portable above 8
constexpr int SLOTS = 2 * MAX_CLUSTER;     // maxima, then sums, of the ranks
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;        // Hopper's opt-in limit a block
// the static shared memory budget (the warps' maxima and sums, two
// mbarriers: 80 bytes), which MAX_V in the wrapper leaves beside the row
constexpr size_t STATIC_SMEM = 128;

// The unit a thread loads: 16 bytes of T (VEC) or one T.
template <typename T, bool VEC> struct Unit;
template <> struct Unit<float, true> {
  using V = float4;
  static constexpr int N = 4;
};
template <> struct Unit<__nv_bfloat16, true> {
  using V = uint4;
  static constexpr int N = 8;
};
template <typename T> struct Unit<T, false> {
  using V = T;
  static constexpr int N = 1;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void unpack(float4 v, float (&f)[4]) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
// little-endian bf16 pairs: a bf16 is the high half of its f32
__device__ __forceinline__ void unpack(uint4 v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ void unpack(T v, float (&f)[1]) { f[0] = to_f32(v); }

__device__ __forceinline__ float4 pack(const float (&f)[4]) {
  return make_float4(f[0], f[1], f[2], f[3]);
}
// round to nearest even, as torch's .to()
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}
template <typename T> __device__ __forceinline__ T pack1(float x);
template <> __device__ __forceinline__ float pack1<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 pack1<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N f32 values of a unit in shared memory (16-byte aligned when N % 4 == 0)
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = reinterpret_cast<const float4*>(p)[k / 4];
      f[k] = v.x; f[k + 1] = v.y; f[k + 2] = v.z; f[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = p[k];
  }
}
template <int N>
__device__ __forceinline__ void store_vals(float* p, const float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      reinterpret_cast<float4*>(p)[k / 4] =
          make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = f[k];
  }
}

// ---- the exchange: remote stores that complete the receiver's mbarrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// an mbarrier of one arrival (its own block's expect_tx)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// arrive, expecting `bytes` of remote stores before the phase completes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for phase 0 to complete (each mbarrier serves one exchange)
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done)
                 : "r"(smem_addr(bar))
                 : "memory");
}

// v into `slot` of block `rank` of the cluster (slot and bar are this
// block's addresses of the same variables), completing 4 bytes of its bar
__device__ __forceinline__ void push(float* slot, uint64_t* bar, float v,
                                     int rank) {
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(smem_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// floats of dynamic shared memory a block needs: the exchange slots (c > 1)
// and its slice, at most ceil(ceil(V / N) / c) units plus the head and tail
// scalars (fewer than N each); the whole row at c = 1
template <int N>
size_t smem_floats(int V, int c) {
  if (c == 1) return static_cast<size_t>(V);
  const size_t units = (static_cast<size_t>(V) + N - 1) / N;
  return SLOTS + ((units + c - 1) / c + 2) * N;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int V) {
  using VT = typename Unit<T, VEC>::V;
  constexpr int N = Unit<T, VEC>::N;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_max[WARPS], red_sum[WARPS];
  __shared__ __align__(8) uint64_t bars[2];   // the two exchanges

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x / c;
  float* slots = smem;                   // c > 1: [rank] max, [16 + rank] sum
  float* vals = smem + (c > 1 ? SLOTS : 0);
  const T* xr = x + row * V;
  T* orow = out + row * V;
  if (c > 1) {   // the mbarriers, seen by the cluster once 2. waits
    if (tid == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  // the row: `head` scalars up to x's first 16-byte boundary, nvec whole
  // units, `tail` scalars; this block's units [u0, u0 + nu), and its
  // scalars: the head on rank 0, the tail on rank c - 1
  int head = 0;
  if constexpr (VEC)
    head = min(static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(xr) & 15))
                                 & 15) / sizeof(T)), V);
  const int nvec = (V - head) / N;
  const int tail = V - head - nvec * N;
  const int u0 = static_cast<int>(static_cast<long long>(nvec) * rank / c);
  const int nu =
      static_cast<int>(static_cast<long long>(nvec) * (rank + 1) / c) - u0;
  const int nh = rank == 0 ? head : 0;
  const int ns = nh + (rank == c - 1 ? tail : 0);
  const auto col = [&](int j) { return j < nh ? j : V - tail + (j - nh); };
  const VT* xv = reinterpret_cast<const VT*>(xr + head) + u0;
  VT* ov = reinterpret_cast<VT*>(orow + head) + u0;
  float* sv = vals + nu * N;             // the scalars' values

  // 1: the slice into shared memory, each thread's max
  float m = -INFINITY;
  for (int base = 0; base < nu; base += UNROLL * THREADS) {
    VT r[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = base + k * THREADS + tid;
      if (i < nu) r[k] = xv[i];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = base + k * THREADS + tid;
      if (i < nu) {
        float f[N];
        unpack(r[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) m = fmaxf(m, f[e]);
        store_vals<N>(vals + i * N, f);
      }
    }
  }
  for (int j = tid; j < ns; j += THREADS) {
    const float f = to_f32(xr[col(j)]);
    sv[j] = f;
    m = fmaxf(m, f);
  }

  // 2: the row max, over the warps, then over the cluster's ranks
  m = warp_max(m);
  if (lane == 0) red_max[warp] = m;
  __syncthreads();
  m = red_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_max[w]);
  if (c > 1) {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (tid < c) push(slots + rank, &bars[0], m, tid);
    if (tid == 0) mbar_expect(&bars[0], 4 * c);
    mbar_wait(&bars[0]);
    m = slots[0];
    for (int r = 1; r < c; ++r) m = fmaxf(m, slots[r]);
  }

  // 3: exp(x - m) in place and its sum, in the same order on every block
  float s = 0.f;
  for (int i = tid; i < nu; i += THREADS) {
    float f[N];
    load_vals<N>(vals + i * N, f);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      f[e] = expf(f[e] - m);
      s += f[e];
    }
    store_vals<N>(vals + i * N, f);
  }
  for (int j = tid; j < ns; j += THREADS) {
    const float e = expf(sv[j] - m);
    sv[j] = e;
    s += e;
  }
  s = warp_sum(s);
  if (lane == 0) red_sum[warp] = s;
  __syncthreads();
  s = red_sum[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += red_sum[w];
  if (c > 1) {
    if (tid < c) push(slots + MAX_CLUSTER + rank, &bars[1], s, tid);
    if (tid == 0) mbar_expect(&bars[1], 4 * c);
    mbar_wait(&bars[1]);
    s = slots[MAX_CLUSTER];
    for (int r = 1; r < c; ++r) s += slots[MAX_CLUSTER + r];
  }

  // 4: the slice written once, e / s
  for (int i = tid; i < nu; i += THREADS) {
    float f[N];
    load_vals<N>(vals + i * N, f);
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = f[e] / s;
    if constexpr (VEC)
      ov[i] = pack(f);
    else
      ov[i] = pack1<T>(f[0]);
  }
  for (int j = tid; j < ns; j += THREADS) orow[col(j)] = pack1<T>(sv[j] / s);
}

// the vector instance takes x and out when both are equally aligned
// modulo 16 bytes (each row then starts at the same offset in both)
bool vector_route(const void* x, const void* out) {
  return (reinterpret_cast<uintptr_t>(x) & 15) ==
         (reinterpret_cast<uintptr_t>(out) & 15);
}

// the kernel of the route, its dynamic shared memory at (V, c), and the
// attributes that launch set: the opt-in above 48 KB, clusters above 8
template <typename T, bool VEC>
cudaError_t prepare(int V, int c, size_t* smem) {
  if (V < 1 || c < 1 || c > MAX_CLUSTER || (c & (c - 1)) != 0)
    return cudaErrorInvalidValue;
  *smem = smem_floats<Unit<T, VEC>::N>(V, c) * sizeof(float);
  if (*smem + STATIC_SMEM > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = softmax_rows_kernel<T, VEC>;
  if (*smem > DEFAULT_SMEM - STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (err != cudaSuccess) return err;
  }
  if (c > 8)
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return cudaSuccess;
}

// B rows of c blocks, clusters of c (the attribute lives in *attr)
cudaLaunchConfig_t config(int B, int c, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * c);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, void* out, int B, int V, int c,
                   cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare<T, VEC>(V, c, &smem);
  if (err != cudaSuccess) return err;
  if (B < 1 || static_cast<long long>(B) * c > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B, c, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, softmax_rows_kernel<T, VEC>,
                           static_cast<const T*>(x), static_cast<T*>(out), V);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t clusters(int V, int c, int* n) {
  size_t smem;
  const cudaError_t err = prepare<T, VEC>(V, c, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, c, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(softmax_rows_kernel<T, VEC>), &cfg);
}

}  // namespace

// Element kinds, shared with the Python wrapper (ops/dev/bench_softmax.py).
enum { KIND_F32 = 0, KIND_BF16 = 1 };

#define SOFTMAX_DISPATCH(FN, ...)                                         \
  do {                                                                    \
    const bool vec = vector_route(x, out);                                \
    if (x_kind == KIND_F32)                                               \
      return static_cast<int>(vec ? FN<float, true>(__VA_ARGS__)          \
                                  : FN<float, false>(__VA_ARGS__));       \
    if (x_kind == KIND_BF16)                                              \
      return static_cast<int>(vec ? FN<__nv_bfloat16, true>(__VA_ARGS__)  \
                                  : FN<__nv_bfloat16, false>(__VA_ARGS__)); \
    return static_cast<int>(cudaErrorInvalidValue);                       \
  } while (0)

// x_kind: KIND_F32 | KIND_BF16 (out has x's kind); c: the cluster size, a
// power of two in [1, 16]. Returns cudaGetLastError() after the launch; an
// unsupported kind or cluster size, or a slice too wide for shared memory,
// returns cudaErrorInvalidValue without launching.
extern "C" int softmax_rows(int x_kind, const void* x, void* out, int B,
                            int V, int c, void* stream) {
  SOFTMAX_DISPATCH(launch, x, out, B, V, c, static_cast<cudaStream_t>(stream));
}

// *n: how many clusters of c blocks of the instance that softmax_rows
// would launch for (x, out, V) the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 when it cannot launch one). Returns
// a CUDA error code.
extern "C" int softmax_rows_clusters(int x_kind, const void* x,
                                     const void* out, int V, int c, int* n) {
  SOFTMAX_DISPATCH(clusters, V, c, n);
}

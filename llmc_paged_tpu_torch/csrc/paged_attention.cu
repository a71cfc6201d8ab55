// Flash-decode "parts" over a paged KV pool, single query a row, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of llmc_paged_tpu/ops/paged_attention.py:
//   * _make_flash_decode_flat_kernel(B, quant=False)   (float/bf16 pools)
//   * _make_flash_decode_flat_kernel(B, quant=True), pinned-scale and
//     scale_dma variants                                 (int8 pools)
//   * _make_flash_decode_gridb_kernel(quant)             (B*pps > 4096)
// One kernel covers all of them: there is no schedule cap (the TPU's SMEM
// B*pps limit). The page size must be a multiple of 4 (the vector width);
// the TPU's ps % 128 DMA rule does not apply.
//
// Contract: the parts contract of paged_attention_parts.cuh with KQ = 1:
// q (B, NH, HS) f32/bf16 → acc (B, NH, HS), m (B, NH), l (B, NH), all f32
// and UNNORMALIZED. HS = 64 or 128.
//
// Bound on the H100: bytes. At the GPT-2 124M serving shapes (B=8, NH=12,
// HS=64, ps=128, 130-255 tokens a row) a call reads 2.8 MB (int8 K/V and
// scales of the valid tokens) or 10 MB (f32): 0.84 / 2.98 us at 3.35 TB/s.
// So the time is mostly latency: the launch, then the dependent loads of a
// row's length, its table entry and K/V, then the merge.
//
// Design (paged_attention_parts.cuh, QTILE = 1): a block of 8 warps a
// (row, head); the warps split the row's live range in 32-token chunks
// across pages, each with its own online softmax in registers (no barrier
// in the token loop); a lane loads 4 tokens of 16 head dims as vectors,
// all K and V loads of a chunk in flight at once; one merge through
// shared memory at the end.

#include "paged_attention_parts.cuh"

// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). HS: 64 or 128; ps: a multiple of 4.
// Returns cudaGetLastError() after the launch; an unsupported kind, head
// size or page size returns cudaErrorInvalidValue without launching.
extern "C" int flash_decode_parts(int q_kind, int kv_kind, const void* q,
                                  const void* k, const void* v,
                                  const void* ks, const void* vs,
                                  const void* tables, const void* lengths,
                                  const void* starts, void* acc, void* m,
                                  void* l, int B, int NH, int HS, int ps,
                                  int pps, float scale, void* stream) {
  return parts::launch<1>(q_kind, kv_kind, q, k, v, ks, vs, tables, lengths,
                          starts, acc, m, l, B, 1, NH, HS, ps, pps, scale,
                          stream);
}

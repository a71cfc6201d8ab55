// Multi-query flash-decode "parts" over a paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _make_flash_decode_flat_mq_kernel(B, KQ, quant)
// of llmc_paged_tpu/ops/paged_attention.py (float pools, and int8 pools
// with pinned scales or scale_dma), entries
// paged_decode_attention[_quant]_parts_mq. It serves speculative verify
// (KQ = spec_k), prefix-cache suffix prefill (KQ = the suffix bucket) and
// Mellum's grouped-query decode (KQ = the 8 query heads of a K/V head,
// NH = the 4 K/V heads, HS = 128: two tiles of 4, launched side by side).
// The TPU kernel's T <= 64 suffix cut (a VMEM limit) does not exist here:
// any KQ is taken, in tiles of QTILE = 4 queries.
//
// Contract: the parts contract of paged_attention_parts.cuh: q
// (B, KQ, NH, HS) f32/bf16, every query attending the same committed range
// [start, len) with no causal mask inside the pool → acc (B, KQ, NH, HS),
// m (B, KQ, NH), l (B, KQ, NH), all f32 and UNNORMALIZED. HS = 64 or 128; the
// page size a multiple of 4.
//
// Bound on the H100: at the spec-verify shapes (B=8, KQ=4, NH=12, HS=64,
// ps=128, 130-255 tokens a row) a call reads 2.9 MB of int8 K/V and scales
// (10 MB f32) and does 4·KQ·tokens·NH·HS f32 operations: bytes bound
// (0.87 / 3.02 us at 3.35 TB/s against 0.29 us of f32 work), and in
// practice latency bound, as the single-query kernel. From a 32-query
// suffix on an int8 pool the operations bound it.
//
// Design (paged_attention_parts.cuh, QTILE = 4): the single-query design
// with a tile of 4 queries a block: each K element a lane loads is used
// for the 4 queries from registers, and each warp keeps a (m, l, acc) a
// query. spec_k = 4 is one tile, so a verify step reads each live page
// once per (row, head); a suffix of T queries has ceil(T/4) tiles over
// blockIdx.z and reads the pages once per tile (from L2 after the first).
// No page is staged: shared memory holds the q tile and the warps' merge,
// under 11 KB, static, so no launch opts in to more.

#include "paged_attention_parts.cuh"

// q_kind: KIND_F32 | KIND_BF16. kv_kind: KIND_F32 | KIND_BF16 (ks/vs
// ignored) | KIND_I8 (ks/vs required). HS: 64 or 128; ps: a multiple of 4.
// Returns cudaGetLastError() after the launch; an unsupported kind, head
// size or page size returns cudaErrorInvalidValue without launching.
extern "C" int flash_decode_parts_mq(int q_kind, int kv_kind, const void* q,
                                     const void* k, const void* v,
                                     const void* ks, const void* vs,
                                     const void* tables, const void* lengths,
                                     const void* starts, void* acc, void* m,
                                     void* l, int B, int KQ, int NH, int HS,
                                     int ps, int pps, float scale,
                                     void* stream) {
  return parts::launch<4>(q_kind, kv_kind, q, k, v, ks, vs, tables, lengths,
                          starts, acc, m, l, B, KQ, NH, HS, ps, pps, scale,
                          stream);
}

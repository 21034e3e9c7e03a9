// Decode attention: one query token per sequence over a contiguous cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attn_decode/attn_decode.py
// (attn_decode_pallas -> _decode_kernel), GQA mode. q [B, Hq, 128],
// k/v [B, Hkv, S, 128] in the model dtype, cache_pos [B] int32: positions
// 0..cache_pos[b] are valid. Output fp32 [B, Hq, 128].
//
// Numerics follow the plain version (the JAX attn_decode ref, GQA mode):
// the query is pre-scaled and rounded to the cache dtype, scores and the
// weighted sum of V accumulate in fp32, the output is fp32.
//
// Bound on the H100: bytes. Each valid K and V row is read once and used
// for a handful of flops per byte. Design: one block per (sequence, KV
// head) serves all g = Hq / Hkv query heads of the group, so each K/V row
// is read from device memory once for the whole group, the bandwidth
// point of GQA. The block walks the cache in tiles of 64 positions up to
// cache_pos[b] only (the Pallas kernel streams the whole cache and masks),
// with an fp32 online softmax: the tile loop of decode_tile.cuh, which the
// paged and verify kernels share. A sequence's result never depends on the
// other sequences of the batch.
#include "decode_tile.cuh"

KERNEL_API int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* cache_pos, void* out, int B,
                                  int Hq, int Hkv, int S, float scale,
                                  int dtype, void* stream) {
  return decode::launch<16>(q, k, v, cache_pos, out, B, Hq, 1, S, scale,
                            dtype, decode::Contiguous{Hkv, S}, stream);
}

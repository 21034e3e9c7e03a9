// Decode attention: one query token per sequence over a contiguous cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/attn_decode/attn_decode.py
// (attn_decode_pallas -> _decode_kernel), GQA mode. q [B, Hq, D],
// k/v [B, Hkv, S, D] in the model dtype, D = 128 or 64, cache_pos [B]
// int32: positions 0..cache_pos[b] are valid. Output fp32 [B, Hq, D].
//
// Numerics follow the plain version (the JAX attn_decode ref, GQA mode):
// the query is pre-scaled and rounded to the cache dtype, scores and the
// weighted sum of V accumulate in fp32, the output is fp32.
//
// Bound on the H100: bytes in principle (each valid K and V row is read
// once and used for a handful of flops per byte), latency at serving
// shapes: a cache of a few hundred positions is a few tiles a sequence.
// Design: decode_tile.cuh's gqa_decode_kernel at K1 = 1, the kernel the
// paged and verify kernels run too. Each block serves RB query rows of one
// (sequence, KV head) and walks the cache in tiles of 64 positions up to
// cache_pos[b] only (the Pallas kernel streams the whole cache and
// masks), staged by cp.async, double-buffered, with an fp32 online
// softmax; RB is the largest that still gives ~128 blocks (1 at yi-9b's
// and jamba's B = 4), so the query rows of a group spread over the SMs. A
// sequence's result never depends on the other sequences of the batch.
#include "decode_tile.cuh"

KERNEL_API int attn_decode_hd_launch(const void* q, const void* k,
                                     const void* v, const void* cache_pos,
                                     void* out, int B, int Hq, int Hkv, int S,
                                     int D, float scale, int dtype,
                                     void* stream) {
  return decode::launch(q, k, v, cache_pos, out, B, Hq, 1, S, D, scale, dtype,
                        decode::Contiguous{Hkv, S}, stream);
}

// D = 128 through the signature of earlier checkouts (kernel_ab.py calls
// another checkout's kernel through it)
KERNEL_API int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* cache_pos, void* out, int B,
                                  int Hq, int Hkv, int S, float scale,
                                  int dtype, void* stream) {
  return attn_decode_hd_launch(q, k, v, cache_pos, out, B, Hq, Hkv, S, 128,
                               scale, dtype, stream);
}

// Precise-mode (MLA absorbed) decode attention over a contiguous latent
// cache, fp32 online softmax.
//
// Replaces the precise mode of the Pallas TPU kernel
// src/repro/kernels/attn_decode/attn_decode.py (attn_decode_pallas with
// precise=True): one query token per sequence against the MLA latent
// cache, which is both K and V, plus the shared rotary key.
//   q  fp32 [B, H, 512], q2 fp32 [B, H, 64]
//   c  [B, S, 512], kr [B, S, 64] (model dtype)
//   out fp32 [B, H, 512]
// The arithmetic and the schedule are mla_tile.cuh's, which the paged
// kernel shares.
//
// Bound on the H100: at serving lengths the latent of one sequence is a
// few hundred KB, so the kernel is far below the card's byte and flop
// floors; what it costs is latency, above all each position's chain of
// 576 dependent fmafs (the header has the schedule: a block a head and
// sequence, rounds of tiles staged by cp.async, a round's tiles scored at
// once).
#include "mla_tile.cuh"

KERNEL_API int attn_decode_mla_launch(const void* q, const void* q2,
                                      const void* c, const void* kr,
                                      const void* cache_pos, void* out, int B,
                                      int H, int S, float scale, int dtype,
                                      void* stream) {
  return mla::launch(q, q2, c, kr, cache_pos, out, B, H, S, scale, dtype,
                     mla::Contiguous{S}, stream);
}

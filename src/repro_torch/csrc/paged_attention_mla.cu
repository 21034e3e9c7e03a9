// Precise-mode (MLA absorbed) paged decode attention: one query token per
// sequence over latent pages behind a page table, fp32 online softmax.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py
// (paged_attention_pallas -> _paged_kernel with post_scale=True), precise
// mode. q fp32 [B, H, 512], q2 fp32 [B, H, 64]; latent pool c [P, ps, 512]
// (K and V at once) and rotary pool kr [P, ps, 64] in the model dtype;
// page_table [B, NP] int32 (entry j names the pool page of positions
// [j ps, (j + 1) ps), -1 = none); cache_pos [B] int32: positions
// 0..cache_pos[b] are valid. Output fp32 [B, H, 512].
//
// The Pallas kernel concatenates q|q2 and the latent|rotary pools before
// its call, a copy of the whole latent pool per call; here the rotary pool
// is a third input and q2 . kr is added inside the kernel.
//
// Bound on the H100: as the contiguous precise kernel, latency at serving
// lengths (each valid latent and rotary row is read once a head). Design:
// the kernel and plan of mla_tile.cuh with the storage row of position p
// read from page_table[b, p / ps]; the page size divides the 32-position
// tile. Positions on a -1 page are weighted 0 and never read. On the same
// latent the output equals attn_decode_mla's bit for bit.
#include "mla_tile.cuh"

KERNEL_API int paged_attention_mla_launch(const void* q, const void* q2,
                                          const void* c_pages,
                                          const void* kr_pages,
                                          const void* page_table,
                                          const void* cache_pos, void* out,
                                          int B, int H, int ps, int NP,
                                          float scale, int dtype,
                                          void* stream) {
  const mla::Paged rows{static_cast<const int*>(page_table),
                        __builtin_ctz(ps), NP};
  return mla::launch(q, q2, c_pages, kr_pages, cache_pos, out, B, H,
                     NP * ps, scale, dtype, rows, stream);
}

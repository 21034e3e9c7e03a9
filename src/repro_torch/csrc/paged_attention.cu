// Paged decode attention: one query token per sequence over a page pool.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py
// (paged_attention_pallas -> _paged_kernel), GQA mode. q [B, Hq, D],
// pools k/v [P, Hkv, ps, D] in the model dtype, D = 128 or 64, page_table
// [B, NP] int32 (entry j names the pool page of positions [j ps, (j + 1)
// ps), -1 = none), cache_pos [B] int32: positions 0..cache_pos[b] are
// valid. Output fp32 [B, Hq, D].
//
// Bound on the H100: as contiguous decode, latency at serving shapes.
// Design: decode_tile.cuh's gqa_decode_kernel at K1 = 1, with the row
// address of position p read from page_table[b, p / ps]. The page size
// divides the 64-position tile, so a tile covers whole pages. Positions
// whose page entry is -1 are masked and never read. With attn_decode's
// kernel, plan and tile order, the output equals attn_decode's bit for bit
// on the same KV, which is what makes the paged engine's tokens equal the
// contiguous engine's.
#include "decode_tile.cuh"

KERNEL_API int paged_attention_hd_launch(const void* q, const void* k_pages,
                                         const void* v_pages,
                                         const void* page_table,
                                         const void* cache_pos, void* out,
                                         int B, int Hq, int Hkv, int ps,
                                         int NP, int D, float scale,
                                         int dtype, void* stream) {
  const decode::Paged rows{static_cast<const int*>(page_table), Hkv,
                           __builtin_ctz(ps), NP};
  return decode::launch(q, k_pages, v_pages, cache_pos, out, B, Hq, 1,
                        NP * ps, D, scale, dtype, rows, stream);
}

// D = 128 through the signature of earlier checkouts (kernel_ab.py calls
// another checkout's kernel through it)
KERNEL_API int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* page_table,
                                      const void* cache_pos, void* out, int B,
                                      int Hq, int Hkv, int ps, int NP,
                                      float scale, int dtype, void* stream) {
  return paged_attention_hd_launch(q, k_pages, v_pages, page_table,
                                   cache_pos, out, B, Hq, Hkv, ps, NP, 128,
                                   scale, dtype, stream);
}

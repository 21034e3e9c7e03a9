// Multi-token verify attention of speculative decoding, contiguous and
// paged.
//
// Replaces the Pallas TPU kernels src/repro/kernels/verify_decode/
// verify_decode.py (verify_decode_pallas -> _verify_kernel and
// verify_decode_paged_pallas -> _verify_paged_kernel). q [B, Hq, K1, D]
// holds K1 = k + 1 query tokens per sequence, D = 128 or 64; query i
// attends positions 0..cache_pos[b] + i, the window of the i-th sequential
// decode step. KV is contiguous [B, Hkv, S, D] or pools [P, Hkv, ps, D]
// with a page table [B, NP] (-1 = none). Output fp32 [B, Hq, K1, D].
//
// Bound on the H100: bytes (each valid K and V row read once for the g *
// K1 query rows of its KV group), but at serving shapes latency (a few
// tiles a sequence). Row i's result must equal attn_decode
// (attn_decode_paged) at cache_pos + i bit for bit, which is what makes
// greedy speculative tokens equal plain greedy tokens; so both launch the
// one kernel of decode_tile.cuh, gqa_decode_kernel, which serves every
// row with the same arithmetic whatever K1 and whatever rows share its
// block (the header has the schedule: row groups over >= 128 blocks,
// cp.async-staged K/V tiles, interleaved butterflies).
#include "decode_tile.cuh"

KERNEL_API int verify_decode_hd_launch(const void* q, const void* k,
                                       const void* v, const void* cache_pos,
                                       void* out, int B, int Hq, int Hkv,
                                       int K1, int S, int D, float scale,
                                       int dtype, void* stream) {
  return decode::launch(q, k, v, cache_pos, out, B, Hq, K1, S, D, scale,
                        dtype, decode::Contiguous{Hkv, S}, stream);
}

KERNEL_API int verify_decode_paged_hd_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* cache_pos, void* out, int B, int Hq,
    int Hkv, int K1, int ps, int NP, int D, float scale, int dtype,
    void* stream) {
  const decode::Paged rows{static_cast<const int*>(page_table), Hkv,
                           __builtin_ctz(ps), NP};
  return decode::launch(q, k_pages, v_pages, cache_pos, out, B, Hq, K1,
                        NP * ps, D, scale, dtype, rows, stream);
}

// D = 128 through the signatures of earlier checkouts (kernel_ab.py calls
// another checkout's kernels through them)
KERNEL_API int verify_decode_launch(const void* q, const void* k,
                                    const void* v, const void* cache_pos,
                                    void* out, int B, int Hq, int Hkv, int K1,
                                    int S, float scale, int dtype,
                                    void* stream) {
  return verify_decode_hd_launch(q, k, v, cache_pos, out, B, Hq, Hkv, K1, S,
                                 128, scale, dtype, stream);
}

KERNEL_API int verify_decode_paged_launch(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* page_table,
                                          const void* cache_pos, void* out,
                                          int B, int Hq, int Hkv, int K1,
                                          int ps, int NP, float scale,
                                          int dtype, void* stream) {
  return verify_decode_paged_hd_launch(q, k_pages, v_pages, page_table,
                                       cache_pos, out, B, Hq, Hkv, K1, ps, NP,
                                       128, scale, dtype, stream);
}

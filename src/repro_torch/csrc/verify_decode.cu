// Multi-token verify attention of speculative decoding, contiguous and
// paged.
//
// Replaces the Pallas TPU kernels src/repro/kernels/verify_decode/
// verify_decode.py (verify_decode_pallas -> _verify_kernel and
// verify_decode_paged_pallas -> _verify_paged_kernel). q [B, Hq, K1, 128]
// holds K1 = k + 1 query tokens per sequence; query i attends positions
// 0..cache_pos[b] + i, the window of the i-th sequential decode step.
// KV is contiguous [B, Hkv, S, 128] or pools [P, Hkv, ps, 128] with a page
// table [B, NP] (-1 = none). Output fp32 [B, Hq, K1, 128].
//
// Bound on the H100: bytes. One pass over the K/V rows serves all g * K1
// query rows of a KV group, so the cache is read once where K1 sequential
// decode steps would read it K1 times. Design: the tile loop of
// decode_tile.cuh with R = g * K1 <= 64 rows a block (shared memory sized
// for 64), each row masked at its own staircase limit. Row i's result
// equals attn_decode (attn_decode_paged) at cache_pos + i bit for bit,
// which is what makes greedy speculative tokens equal plain greedy tokens.
#include "decode_tile.cuh"

KERNEL_API int verify_decode_launch(const void* q, const void* k,
                                    const void* v, const void* cache_pos,
                                    void* out, int B, int Hq, int Hkv, int K1,
                                    int S, float scale, int dtype,
                                    void* stream) {
  return decode::launch<64>(q, k, v, cache_pos, out, B, Hq, K1, S, scale,
                            dtype, decode::Contiguous{Hkv, S}, stream);
}

KERNEL_API int verify_decode_paged_launch(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* page_table,
                                          const void* cache_pos, void* out,
                                          int B, int Hq, int Hkv, int K1,
                                          int ps, int NP, float scale,
                                          int dtype, void* stream) {
  const decode::Paged rows{static_cast<const int*>(page_table), Hkv, ps, NP};
  return decode::launch<64>(q, k_pages, v_pages, cache_pos, out, B, Hq, K1,
                            NP * ps, scale, dtype, rows, stream);
}

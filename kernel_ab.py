#!/usr/bin/env python3
"""Hold one of this checkout's kernels against another checkout's, on one
CUDA card: bit for bit (or, where the bits differ by design, each against
the plain version), and timed in turns.

    python3 kernel_ab.py --baseline DIR                        # attn_decode
    python3 kernel_ab.py --baseline DIR --kernel moe_decode
    python3 kernel_ab.py --baseline DIR --kernel attn_decode_mla
    python3 kernel_ab.py --baseline DIR --kernel verify_decode
    python3 kernel_ab.py --baseline DIR --kernel attention
    python3 kernel_ab.py --baseline DIR --kernel gemm
    python3 kernel_ab.py --baseline DIR --kernel gemm_heads
    python3 kernel_ab.py --baseline DIR --kernel mlstm_decode
    python3 kernel_ab.py --baseline DIR --kernel rmsnorm
    python3 kernel_ab.py --baseline DIR --kernel mamba_decode
    python3 kernel_ab.py --baseline DIR --kernel ssm_scan
    python3 kernel_ab.py --baseline DIR --kernel entropy_exit

DIR is the root of another checkout. For the decode-attention, flash,
``moe_decode``, ``mlstm_decode``, ``rmsnorm``, ``mamba_decode`` (its
``csrc/ssm_decode.cu``), ``ssm_scan`` and ``entropy_exit`` modes its
``csrc/<kernel>.cu`` is built with this
checkout's nvcc flags into ``build/ab/`` and called through its C entry
point (the same signature; the decode-attention modes through the D = 128
entry points every checkout keeps); this checkout's kernel runs through
its wrapper. The GEMM modes call each checkout's own wrapper instead, so they
hold whatever C signature either side has.

``attn_decode``: at each shape (bf16, the serving path's GQA widths:
yi-9b's 32 / 4 heads and jamba's 32 / 8) this checkout's
``attn_decode`` and ``attn_decode_paged`` (the same KV behind a shuffled
page table) must give the baseline's contiguous kernel's bits, and the
baseline's paged kernel must too: the exit code says so. Then baseline,
change, paged change, paged baseline, paged baseline, paged change,
change, baseline are timed.

``attn_decode_mla`` (the precise, MLA mode of decode attention): at
deepseek-v2-lite-16b's widths (16 heads, latent 512 + rotary 64, fp32
queries, bf16 latent) the same bit equalities, through the precise
kernels, timed as ``attn_decode``.

``verify_decode``: at yi-9b's speculative-decoding shapes (bf16, 32 / 4
heads, K1 = 2 and 4 query tokens; the caches of ``attn_decode``, 160 and
2048 positions) this checkout's ``verify_decode`` and
``verify_decode_paged`` (the same KV behind a shuffled page table) must
give the baseline's contiguous kernel's bits, and the baseline's paged
kernel must too. Then baseline, change, paged change, paged baseline,
paged baseline, paged change, change, baseline are timed.

``attention`` (the flash prefill kernel, both bf16 instances: (128, 128)
at yi-9b's serve buckets and ``check_prefill``'s B = 8 x 100 tokens, and
(192, 128) at deepseek's prefill lengths): the bits differ by design, so
each side's max abs error against the plain version is reported and
held to 1e-2 + 1e-2 |ref|; baseline, change, change, baseline are timed.

``moe_decode``: at deepseek-v2-lite-16b's serving shapes (d 2048, 64
experts of 1408, top-6; 4 live slots, one slot, and a dead slot with a
repeated expert) and jamba-v0.1-52b's (d 4096, 16 experts of 14336,
top-2; 4 live slots): the bits may differ by design (two kernels that
partition the k sums otherwise round otherwise), so each side's max abs
error against the plain version is reported and held to 1e-4 + 1e-4
|ref| (fp32 on both sides; the exit code), bits equal or not beside it;
baseline, change, change, baseline are timed.

``gemm`` (``csrc/gemm.cu``: the bf16 GEMM, its int8-weight instance and
the fp32 GEMM): at every decode GEMM shape of yi-9b, deepseek-v2-lite-16b,
jamba-v0.1-52b, xlstm-350m and musicgen-medium that ``chip_smoke.py``
times (M = 4 slots), yi-9b's at M = 16 (spec verify) and M = 128
(prefill), and the fp32
routers, ``w_if`` and 4096 -> 512, and the seizure models' two-class
heads (M = 256, K = 32 / 128 / 64, N = 2); then the decode shapes of
chatglm3-6b, qwen1.5-32b, qwen3-moe-30b-a3b (and its fp32 router 2048 ->
128), chameleon-34b and mistral-large-123b. ``gemm_heads``: at the
three layouts' serving shapes (MLA's absorbed products, xLSTM's
head-major q/k/v and sLSTM ``wr``). Each checkout's wrapper runs in
processes of its own, baseline, change, change, baseline, baseline,
change, on the same inputs (made on the card from fixed seeds): each
process times every shape and
the host's us a wrapper call at a few (bf16, int8-weight and the fp32
router 2048 -> 64; MLA's transposed ``w_uk`` and xLSTM's head-major
q/k/v: the median of 11 runs of 100 enqueued calls). Reported per shape:
bits equal or not, each side's max abs error against the plain version
(held to 1e-2 + 1e-2 |ref| in bf16, 1e-4 + 1e-4 |ref| in fp32) and each
process's time. The bf16 and int8-weight kernels reduce every element in
one K order (k16 steps from 0), so their bits must equal the baseline's;
the fp32 kernel's split of K changes its sums by design. The W8A8 cases
(``gemm_int8``: yi-9b's five shapes at M = 4, 16 and 128, and M = 5, K =
1000, N = 300 with a bias) hold each side's own ``gemm_int8`` against
``gemm_w8a8_ref``: the integer sums are exact in any order and the
epilogue is fixed, so their bits must equal the baseline's too, on every
row.

``mlstm_decode`` (the mLSTM mode of ``ssm_decode``): at xlstm-350m's
serving shape (B = 4 slots, 4 heads, dh 512, fp32) and at B = 1. C', n'
and m' must keep the baseline's bits (the exit code); h, whose sum over
rows may take another order, is held on each side to the plain version
within 1e-4 of the largest |h| plus 1e-4 |ref|, its bits equal or not
beside it; baseline, change, change, baseline are timed, and traced with
torch.profiler for the device's own time a call (``traced_us``; the
events' reading also holds the launch and the flush's aftermath); beside
them, PyTorch's copy of C (``copy_ms``, ``copy_traced_us``), which moves
the same bytes.

``rmsnorm``: at every shape the serving path gives it (yi-9b's and
jamba's layer norms [4, 4096] bf16 with an fp32 scale, the exit head's
with a bf16 scale, deepseek's [4, 2048] and its ``kv_norm`` [4, 512],
xlstm's block norms [4, 1024], its mLSTM head norm [16, 512] fp32 with a
unit scale and its sLSTM norm [4, 1024] fp32) and at yi-9b's prefill of
128 tokens [128, 4096]: each side's max abs error against the plain
version (held to 1e-2 + 1e-2 |ref| for bf16 outputs, one bf16 ulp, and
1e-4 + 1e-4 |ref| for fp32; the exit code), bits equal or not (the
reduction's order changed by design). A call at decode takes a few
microseconds, under the cold-L2 timer's floor (6-9 us a call whatever the
kernel does), so each side is also timed as one CUDA graph of 100
back-to-back launches on the same inputs, replayed (us a launch, the
inputs warm in L2 as the decode step leaves x), in turns baseline,
change, change, baseline; and 100 eager launches of each side are traced
with torch.profiler for the device's own time a launch (``traced_us``).

``mamba_decode`` (the Mamba mode of ``ssm_decode``): at jamba-v0.1-52b's
serving shape (B = 4 slots, d_inner 8192, d_state 16, fp32) and at B = 1.
y and h' must keep the baseline's bits, from a separate output and
written in place (``out=h``, as the mixer calls it): the exit code. Each
side is held to the plain version within 1e-4 + 1e-4 |ref|. Baseline,
change, change in place, change in place, change, baseline are timed
(cold L2; at the timer's floor for a kernel this size) and traced for
the device's own time a call (``traced_us``), beside PyTorch's copy of h
(``copy_ms``, ``copy_traced_us``), which moves the same bytes.

``ssm_scan``: at jamba-v0.1-52b's prefill, one prompt of 20, 57 and 120
tokens (d_inner 8192, d_state 16, bf16 u, dt, B and C, with h0 as the
engine passes it; at 120 also without). y and h_T must keep the
baseline's bits (the exit code); each side is held to the plain version
(y one bf16 ulp, h_T 1e-4 + 1e-4 |ref|); baseline, change, change,
baseline are timed (cold L2) and traced (``traced_us``).

``entropy_exit``: at each served vocabulary with 4 live slots (bf16:
xlstm-350m's 50304, yi-9b's 64000, jamba-v0.1-52b's 65536,
deepseek-v2-lite-16b's 102400), yi-9b's at one live slot and its fp32
logits [4, 64000]. Each side is held to the plain version within 1e-4 +
1e-4 |ref| and, bitwise, row b of the M = 4 launch must equal its M = 1
launch (both the exit code); bits equal to the baseline's are reported,
not required (the sum order changed by design). Baseline, change,
change, baseline are timed cold, as one replayed CUDA graph of 100
launches (``graph_us``) and traced (``traced_us``); the plain version and
the library yardstick (``Categorical(logits=...).entropy() / log V``)
are timed cold beside them.

Times are medians of 20 cold-L2 calls each (CUDA events) unless said
otherwise: one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (batch, cache extent, cache_pos per sequence)
SHAPES = ((4, 160, (19, 75, 130, 159)),
          (4, 160, (0, 1, 63, 64)),
          (4, 2048, (100, 1000, 1500, 2047)))
HQ, HKV, D, PS = 32, 4, 128, 16
# GQA head layouts of attn_decode: yi-9b's (Hq, Hkv), then jamba's
HEADS = ((HQ, HKV), (32, 8))


# the paged kernel of the baseline held beside its contiguous one
PAGED_SOURCE = {"attn_decode": "paged_attention",
                "attn_decode_mla": "paged_attention_mla"}


def build_baseline(baseline: Path, kernel: str) -> ctypes.CDLL:
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    csrc = baseline / "src" / "repro_torch" / "csrc"
    out = ROOT / "build" / "ab" / f"{kernel}_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                    str(csrc / f"{kernel}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    if kernel == "attn_decode":
        lib.attn_decode_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                           ctypes.c_float, i, p]
        lib.attn_decode_launch.restype = i
    elif kernel == "paged_attention":
        lib.paged_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_launch.restype = i
    elif kernel == "paged_attention_mla":
        lib.paged_attention_mla_launch.argtypes = [p] * 7 + [
            i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_mla_launch.restype = i
    elif kernel == "verify_decode":
        lib.verify_decode_launch.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                             ctypes.c_float, i, p]
        lib.verify_decode_launch.restype = i
        lib.verify_decode_paged_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.verify_decode_paged_launch.restype = i
    elif kernel == "flash_attention":
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = i
    elif kernel == "attn_decode_mla":
        lib.attn_decode_mla_launch.argtypes = [p] * 6 + [
            i, i, i, ctypes.c_float, i, p]
        lib.attn_decode_mla_launch.restype = i
    elif kernel == "mlstm_decode":
        lib.mlstm_decode_launch.argtypes = [p] * 12 + [i] * 3 + [p]
        lib.mlstm_decode_launch.restype = i
    elif kernel == "ssm_decode":
        lib.mamba_decode_launch.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.mamba_decode_launch.restype = i
    elif kernel == "ssm_scan":
        lib.ssm_scan_launch.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.ssm_scan_launch.restype = i
    elif kernel == "rmsnorm":
        lib.rmsnorm_launch.argtypes = [p, p, p, i, i, ctypes.c_float, i, i,
                                       p]
        lib.rmsnorm_launch.restype = i
    elif kernel == "entropy_exit":
        lib.entropy_launch.argtypes = [p, p, i, i, ctypes.c_float, i, p]
        lib.entropy_launch.restype = i
    else:
        lib.moe_decode_launch.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.moe_decode_launch.restype = i
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--kernel", choices=("attn_decode", "attn_decode_mla",
                                         "moe_decode", "verify_decode",
                                         "attention", "gemm",
                                         "gemm_heads", "mlstm_decode",
                                         "rmsnorm", "mamba_decode",
                                         "ssm_scan", "entropy_exit"),
                    default="attn_decode")
    # one process of a GEMM A/B (``ab_gemm`` starts them): the wrapper of
    # the checkout at --baseline, outputs to --save
    ap.add_argument("--side", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    if args.side:
        return side_run(args.baseline.resolve(), args.kernel, args.save)
    from chip_smoke import Timer, card_line

    if args.kernel in ("gemm", "gemm_heads"):
        rows = ab_gemm(torch, args.baseline.resolve(), args.kernel)
    else:
        source = {"attention": "flash_attention",
                  "mamba_decode": "ssm_decode"}.get(args.kernel, args.kernel)
        base = build_baseline(args.baseline.resolve(), source)
        if args.kernel in PAGED_SOURCE:      # the baseline's paged kernel
            base = (base, build_baseline(args.baseline.resolve(),
                                         PAGED_SOURCE[args.kernel]))
        ab = {"attn_decode": ab_attn_decode, "attn_decode_mla": ab_mla,
              "moe_decode": ab_moe_decode, "verify_decode": ab_verify,
              "attention": ab_attention, "mlstm_decode": ab_mlstm,
              "rmsnorm": ab_rmsnorm, "mamba_decode": ab_mamba,
              "ssm_scan": ab_scan, "entropy_exit": ab_entropy}[args.kernel]
        rows = ab(torch, base, Timer(torch))
    print(card_line())
    # the decode kernels keep each row's arithmetic ("bitwise": the
    # baseline's bits, contiguous and paged), the bf16, int8-weight and
    # W8A8 GEMMs keep one K order (k16 steps from 0), mlstm_decode its
    # state's expressions and the two Mamba kernels all their arithmetic:
    # their bits must equal the baseline's; entropy_exit's rows must not
    # depend on the batch
    ok = all((r["bitwise"] if "bitwise" in r else r["within_tol"])
             and (not r.get("bits_required") or r["bits_equal"])
             and r.get("rows_independent", True) for r in rows)
    print(json.dumps({"ok": ok, "kernel": args.kernel, "rows": len(rows)}))
    return 0 if ok else 1


def ab_attn_decode(torch, base, timer):
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.attn_decode.ops import attn_decode, decode_plan
    from repro_torch.kernels.paged_attention.ops import attn_decode_paged

    base, base_paged = base
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for hq, hkv in HEADS:
        for b, s, cps in SHAPES:
            def randn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda"
                                   ).to(torch.bfloat16)
            q, k, v = randn(b, hq, D), randn(b, hkv, s, D), \
                randn(b, hkv, s, D)
            cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
            # the same KV as pools behind a shuffled page table
            table, kp, vp = shuffled_pages(torch, gen, k, v)

            def run_base(q=q, k=k, v=v, cp=cp, b=b, s=s, hq=hq, hkv=hkv):
                out = torch.empty(b, hq, D, dtype=torch.float32,
                                  device="cuda")
                rc = base.attn_decode_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), cp.data_ptr(),
                    out.data_ptr(), b, hq, hkv, s, D ** -0.5, 1,
                    stream_ptr(q))
                assert rc == 0, rc
                return out

            def run_base_paged(q=q, kp=kp, vp=vp, table=table, cp=cp, b=b,
                               hq=hq, hkv=hkv):
                out = torch.empty(b, hq, D, dtype=torch.float32,
                                  device="cuda")
                rc = base_paged.paged_attention_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), cp.data_ptr(), out.data_ptr(), b, hq,
                    hkv, PS, table.shape[1], D ** -0.5, 1, stream_ptr(q))
                assert rc == 0, rc
                return out

            def run_new(q=q, k=k, v=v, cp=cp):
                return attn_decode(q, k, v, cp)

            def run_paged(q=q, kp=kp, vp=vp, table=table, cp=cp):
                return attn_decode_paged(q, kp, vp, table, cp)

            rows.append(bits_and_times(
                torch, timer, f"q[{b},{hq},{D}] kv[{b},{hkv},{s},{D}] "
                f"cache_pos {list(cps)}; {decode_plan(b, hq, hkv)}",
                run_base, run_new, run_paged, run_base_paged))
    return rows


def bits_and_times(torch, timer, shape, run_base, run_new, run_paged,
                   run_base_paged):
    """One row of a decode A/B: this checkout's contiguous and paged
    kernels and the baseline's paged kernel against the baseline's
    contiguous kernel, bit for bit; then each timed in turns."""
    want = run_base()
    same = torch.equal(run_new(), want)
    same_paged = torch.equal(run_paged(), want)
    same_base_paged = torch.equal(run_base_paged(), want)
    torch.cuda.synchronize()
    t = [timer(fn, iters=20) for fn in (
        run_base, run_new, run_paged, run_base_paged, run_base_paged,
        run_paged, run_new, run_base)]
    row = dict(shape=shape, bitwise=same and same_paged and same_base_paged,
               bitwise_contiguous=same, bitwise_paged=same_paged,
               baseline_ms=[t[0], t[7]], change_ms=[t[1], t[6]],
               paged_baseline_ms=[t[3], t[4]], paged_ms=[t[2], t[5]])
    print(json.dumps(row), flush=True)
    return row


def shuffled_pages(torch, gen, *caches):
    """Contiguous caches [B, H, S, D] (H and D may differ between them) as
    pools [B * S / PS + 1, H, PS, D] behind one shuffled page table (page
    0 unused). Returns (table, pool, ...)."""
    b, _, s, _ = caches[0].shape
    np_ = s // PS
    perm = torch.randperm(b * np_, generator=gen, device="cuda") + 1
    pools = []
    for c in caches:
        h, d = c.shape[1], c.shape[3]
        pool = torch.zeros(b * np_ + 1, h, PS, d, dtype=c.dtype,
                           device="cuda")
        pool[perm] = c.view(b, h, np_, PS, d).transpose(1, 2).reshape(
            b * np_, h, PS, d)
        pools.append(pool)
    return (perm.view(b, np_).to(torch.int32), *pools)


def ab_verify(torch, base, timer):
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.attn_decode.ops import decode_plan
    from repro_torch.kernels.verify_decode.ops import (verify_decode,
                                                       verify_decode_paged)

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for k1 in (2, 4):
        for b, s, cps in SHAPES:
            # the last query of a sequence stays inside the cache
            cps = tuple(min(c, s - k1) for c in cps)

            def randn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda"
                                   ).to(torch.bfloat16)
            q, k, v = randn(b, HQ, k1, D), randn(b, HKV, s, D), \
                randn(b, HKV, s, D)
            cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
            table, kp, vp = shuffled_pages(torch, gen, k, v)
            np_ = s // PS

            def run_base(q=q, k=k, v=v, cp=cp, b=b, s=s, k1=k1):
                out = torch.empty(b, HQ, k1, D, dtype=torch.float32,
                                  device="cuda")
                rc = base.verify_decode_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), cp.data_ptr(),
                    out.data_ptr(), b, HQ, HKV, k1, s, D ** -0.5, 1,
                    stream_ptr(q))
                assert rc == 0, rc
                return out

            def run_base_paged(q=q, kp=kp, vp=vp, table=table, cp=cp, b=b,
                               k1=k1, np_=np_):
                out = torch.empty(b, HQ, k1, D, dtype=torch.float32,
                                  device="cuda")
                rc = base.verify_decode_paged_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), cp.data_ptr(), out.data_ptr(), b, HQ,
                    HKV, k1, PS, np_, D ** -0.5, 1, stream_ptr(q))
                assert rc == 0, rc
                return out

            def run_new(q=q, k=k, v=v, cp=cp):
                return verify_decode(q, k, v, cp)

            def run_paged(q=q, kp=kp, vp=vp, table=table, cp=cp):
                return verify_decode_paged(q, kp, vp, table, cp)

            rows.append(bits_and_times(
                torch, timer, f"q[{b},{HQ},{k1},{D}] kv[{b},{HKV},{s},{D}] "
                f"cache_pos {list(cps)}; {decode_plan(b, HQ, HKV, k1)}",
                run_base, run_new, run_paged, run_base_paged))
    return rows


def ab_attention(torch, base, timer):
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(9)
    # (B, Hq, Hkv, T, Dqk, Dv): yi-9b's serve buckets and check_prefill's
    # batch; deepseek's (192, 128) at a serve prompt and check_prefill's
    cases = [(1, 32, 4, t, 128, 128) for t in (32, 64, 128)] + [
        (8, 32, 4, 100, 128, 128), (1, 16, 16, 100, 192, 128),
        (1, 16, 16, 128, 192, 128), (128, 16, 16, 100, 192, 128)]
    rows = []
    for b, hq, hkv, t, dqk, dv in cases:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
        q, k, v = randn(b, hq, t, dqk), randn(b, hkv, t, dqk), \
            randn(b, hkv, t, dv)

        def run_base(q=q, k=k, v=v, b=b, hq=hq, hkv=hkv, t=t, dqk=dqk,
                     dv=dv):
            out = torch.empty(b, hq, t, dv, dtype=torch.bfloat16,
                              device="cuda")
            rc = base.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, hkv, t, t, dqk, dv, 1, dqk ** -0.5, 1, stream_ptr(q))
            assert rc == 0, rc
            return out

        def run_new(q=q, k=k, v=v):
            return attention(q, k, v, causal=True)

        want = attention_ref(q, k, v, causal=True).float()
        errs, ok = {}, True
        for side, fn in (("baseline", run_base), ("change", run_new)):
            err = (fn().float() - want).abs()
            errs[side] = float(err.max())
            ok = ok and bool((err <= 1e-2 + 1e-2 * want.abs()).all())
        torch.cuda.synchronize()
        t_ = [timer(fn, iters=20) for fn in (run_base, run_new, run_new,
                                             run_base)]
        row = dict(shape=f"q[{b},{hq},{t},{dqk}] kv[{b},{hkv},{t},{dqk}|"
                   f"{dv}] causal", within_tol=ok,
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   baseline_ms=[t_[0], t_[3]], change_ms=[t_[1], t_[2]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# (M, K, N, activation, weights): every decode GEMM shape chip_smoke.py
# times (yi-9b, deepseek, jamba, xlstm, musicgen at M = 4 slots), yi-9b's
# at M = 16 and 128, yi-9b's on int8 weights, and the fp32 GEMMs
GEMM_BF16 = ((4096, 4096, "none"), (4096, 512, "none"),
             (4096, 11008, "silu"), (11008, 4096, "none"),
             (4096, 64000, "none"))
GEMM_CASES = (
    [(4, k, n, a, "bf16") for k, n, a in GEMM_BF16]
    + [(4, k, n, a, "bf16") for k, n, a in (
        (2048, 3072, "none"), (2048, 512, "none"), (2048, 64, "none"),
        (2048, 2048, "none"), (2048, 2816, "silu"), (2816, 2048, "none"),
        (2048, 10944, "silu"), (10944, 2048, "none"), (2048, 102400, "none"),
        (4096, 16384, "none"), (8192, 288, "none"), (256, 8192, "none"),
        (8192, 4096, "none"), (4096, 14336, "silu"), (14336, 4096, "none"),
        (4096, 1024, "none"), (4096, 65536, "none"), (1024, 4096, "none"),
        (2048, 1024, "none"), (1024, 2730, "none"), (1365, 1024, "none"),
        (1024, 50304, "none"), (1536, 1536, "none"), (1536, 6144, "silu"),
        (6144, 1536, "none"), (1536, 2048, "none"))]
    + [(m, k, n, a, "bf16") for m in (16, 128) for k, n, a in GEMM_BF16]
    + [(m, k, n, a, "int8") for m in (4, 16, 128) for k, n, a in GEMM_BF16]
    + [(4, k, n, "none", "fp32") for k, n in (
        (4096, 512), (2048, 64), (4096, 16), (2048, 8))]
    # W8A8 (``gemm_int8``, activations quantized by the wrapper or kernel):
    # yi-9b's shapes at M = 4, 16 and 128, and a ragged shape with a bias
    + [(m, k, n, a, "w8a8") for m in (4, 16, 128) for k, n, a in GEMM_BF16]
    + [(5, 1000, 300, "relu", "w8a8+bias")]
    # the seizure models' fp32 heads at an evaluation batch of 256 (the
    # narrow kernel from PR 25 on; the tiled fp32 kernel before)
    + [(256, k, 2, "none", "fp32") for k in (32, 128, 64)]
    # the rest of the zoo's decode shapes (chatglm3-6b, qwen1.5-32b,
    # qwen3-moe-30b-a3b, chameleon-34b, mistral-large-123b) and qwen3-moe's
    # fp32 router, appended so that the cases above keep their seeds
    + [(4, k, n, a, "bf16") for k, n, a in (
        (4096, 256, "none"), (4096, 13696, "silu"), (13696, 4096, "none"),
        (4096, 65024, "none"), (5120, 5120, "none"), (5120, 27392, "silu"),
        (27392, 5120, "none"), (5120, 152064, "none"), (2048, 4096, "none"),
        (4096, 2048, "none"), (2048, 151936, "none"), (8192, 8192, "none"),
        (8192, 1024, "none"), (8192, 22016, "silu"), (22016, 8192, "none"),
        (12288, 12288, "none"), (12288, 1024, "none"),
        (12288, 28672, "silu"), (28672, 12288, "none"),
        (12288, 32768, "none"))]
    + [(4, 2048, 128, "none", "fp32")])


# (M, H, K, w shape, w dtype, layout) of gemm_heads: MLA's w_uk (read
# transposed, layout 1) and w_uv (layout 0) [512, 16, 128]; xLSTM's q/k/v
# [4, 512, 512] and sLSTM wr [4, 256, 1024] head-major (layout 2)
HEADS_CASES = ((4, 16, 128, (512, 16, 128), "bf16", 1),
               (4, 16, 512, (512, 16, 128), "bf16", 0),
               (4, 4, 512, (4, 512, 512), "bf16", 2),
               (4, 4, 256, (4, 256, 1024), "fp32", 2))
CASES = {"gemm": GEMM_CASES, "gemm_heads": HEADS_CASES}
# the cases whose host cost a wrapper call is also measured: bf16, int8-
# weight and W8A8 (4096 x 4096) and the fp32 router (2048 -> 64, K split);
# MLA's transposed w_uk and xLSTM's head-major q/k/v
HOST_CASES = {"gemm": ((4, 4096, 4096, "none", "bf16"),
                       (4, 4096, 4096, "none", "int8"),
                       (4, 4096, 4096, "none", "w8a8"),
                       (4, 2048, 64, "none", "fp32")),
              "gemm_heads": (HEADS_CASES[0], HEADS_CASES[2])}
# the processes of a GEMM A/B, in turns
SIDES = ("baseline", "change", "change", "baseline", "baseline", "change")


def case_label(kernel: str, case) -> str:
    if kernel == "gemm":
        m, k, n, act, kind = case
        return f"M={m} K={k} N={n} {act} {kind}"
    m, h, k, wshape, wdt, layout = case
    return f"x[{m},{h},{k}] w{list(wshape)} {wdt} layout {layout}"


def case_inputs(torch, weightq, kernel: str, i: int):
    """(x, w, the wrapper's further arguments) of case i, made on the card
    from a seed of its own, the same in every process. int8 weights are
    quantized here, per column (absmax / 127), and wrapped in the calling
    checkout's ``WeightQ`` class ``weightq``."""
    gen = torch.Generator(device="cuda").manual_seed(
        1000 * (kernel == "gemm_heads") + i)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if kernel == "gemm":
        m, k, n, act, kind = GEMM_CASES[i]
        dt = torch.float32 if kind == "fp32" else torch.bfloat16
        x, w = randn(m, k).to(dt), (randn(k, n) * k ** -0.5).to(dt)
        if kind != "bf16" and kind != "fp32":
            scale = w.float().abs().amax(0, keepdim=True).clamp_min(1e-8) / 127
            w = weightq(torch.round(w.float() / scale).clamp(-127, 127)
                        .to(torch.int8), scale)
        bias = randn(n) if kind == "w8a8+bias" else None
        return x, w, (bias, act)
    m, h, k, wshape, wdt, layout = HEADS_CASES[i]
    x = randn(m, h, k)
    w = (randn(*wshape) * k ** -0.5).to(getattr(torch, {
        "bf16": "bfloat16", "fp32": "float32"}[wdt]))
    return x, w, (layout == 1, layout == 2)


def side_run(side: Path, kernel: str, save) -> int:
    """One process of a GEMM A/B: the wrapper of the checkout at ``side``
    on every case: its outputs (saved to ``save`` if given), its time
    (median of 20 cold-L2 calls) and, at HOST_CASES, the host's us a call
    (median of 11 x 100 enqueued calls); one JSON line."""
    import torch

    from chip_smoke import Timer
    sys.path.insert(0, str(side / "src"))   # before any repro_torch import
    from repro_torch.kernels.gemm import ops
    from repro_torch.kernels.gemm.ref import WeightQ
    assert Path(ops.__file__).resolve().is_relative_to(side), ops.__file__
    timer = Timer(torch)
    outs, ms, host = [], [], {}
    for i, case in enumerate(CASES[kernel]):
        x, w, extra = case_inputs(torch, WeightQ, kernel, i)
        fn = (ops.gemm_heads if kernel == "gemm_heads" else
              ops.gemm_int8 if case[-1].startswith("w8a8") else ops.gemm)

        def call(x=x, w=w, extra=extra, fn=fn):
            return fn(x, w, *extra)

        outs.append(call().cpu())
        ms.append(timer(call, iters=20))
        if case in HOST_CASES[kernel]:
            runs = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                runs.append((time.perf_counter() - t0) * 1e4)
            torch.cuda.synchronize()
            host[case_label(kernel, case)] = sorted(runs)[5]
        del x, w
    if save:
        torch.save(outs, save)
    print(json.dumps({"ms": ms, "host_us": host}))
    return 0


def ab_gemm(torch, baseline: Path, kernel: str):
    """The GEMM A/B: each checkout's own wrapper (so no one C signature
    is assumed) in processes of their own, in turns (SIDES); then, case by
    case, bits equal or not and each side's max abs error against this
    checkout's plain version on the same inputs."""
    from repro_torch.kernels.gemm.ref import (WeightQ, gemm_heads_ref,
                                              gemm_ref, gemm_w8a8_ref)

    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    runs, saved = {"baseline": [], "change": []}, {}
    for side in SIDES:
        cmd = [sys.executable, str(ROOT / "kernel_ab.py"), "--kernel", kernel,
               "--baseline", str(baseline if side == "baseline" else ROOT),
               "--side"]
        if side not in saved:
            saved[side] = out_dir / f"{kernel}_{side}.pt"
            cmd += ["--save", str(saved[side])]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"kernel_ab: the {side} process failed")
        runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
    outs = {side: torch.load(path) for side, path in saved.items()}
    rows = []
    for i, case in enumerate(CASES[kernel]):
        x, w, extra = case_inputs(torch, WeightQ, kernel, i)
        plain = (gemm_heads_ref if kernel == "gemm_heads" else gemm_w8a8_ref
                 if case[-1].startswith("w8a8") else gemm_ref)
        want = plain(x, w, *extra).float().cpu()
        fp32 = kernel == "gemm_heads" or case[-1] == "fp32"
        tol = 1e-4 if fp32 else 1e-2
        errs, ok = {}, True
        for side in ("baseline", "change"):
            err = (outs[side][i].float() - want).abs()
            errs[side] = float(err.max())
            ok = ok and bool((err <= tol + tol * want.abs()).all())
        del x, w
        row = dict(shape=case_label(kernel, case), within_tol=ok,
                   bits_equal=torch.equal(outs["baseline"][i],
                                          outs["change"][i]),
                   bits_required=not fp32,
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   baseline_ms=[r["ms"][i] for r in runs["baseline"]],
                   change_ms=[r["ms"][i] for r in runs["change"]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    for case in HOST_CASES[kernel]:
        label = case_label(kernel, case)
        print(json.dumps(dict(
            shape=f"host us a wrapper call, {label}",
            baseline_us=[round(r["host_us"][label], 2)
                         for r in runs["baseline"]],
            change_us=[round(r["host_us"][label], 2)
                       for r in runs["change"]])), flush=True)
    return rows


def ab_mla(torch, base, timer):
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.attn_decode.ops import attn_decode, mla_plan
    from repro_torch.kernels.paged_attention.ops import attn_decode_paged

    base, base_paged = base
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, r, rd = 16, 512, 64
    scale = (128 + rd) ** -0.5
    rows = []
    for b, s, cps in SHAPES:
        def randn(*shape, dtype=torch.bfloat16, sc=1.0):
            return (torch.randn(*shape, generator=gen, device="cuda") * sc
                    ).to(dtype)
        q = randn(b, h, r, dtype=torch.float32, sc=0.5)
        q2 = randn(b, h, rd, dtype=torch.float32)
        lat, kr = randn(b, 1, s, r), randn(b, 1, s, rd)
        cp = torch.tensor(cps, dtype=torch.int32, device="cuda")
        # the same latent as pools behind a shuffled page table
        table, cpool, kpool = shuffled_pages(torch, gen, lat, kr)

        def run_base(q=q, q2=q2, lat=lat, kr=kr, cp=cp, b=b, s=s):
            out = torch.empty(b, h, r, dtype=torch.float32, device="cuda")
            rc = base.attn_decode_mla_launch(
                q.data_ptr(), q2.data_ptr(), lat.data_ptr(), kr.data_ptr(),
                cp.data_ptr(), out.data_ptr(), b, h, s, scale, 1,
                stream_ptr(q))
            assert rc == 0, rc
            return out

        def run_base_paged(q=q, q2=q2, cpool=cpool, kpool=kpool,
                           table=table, cp=cp, b=b):
            out = torch.empty(b, h, r, dtype=torch.float32, device="cuda")
            rc = base_paged.paged_attention_mla_launch(
                q.data_ptr(), q2.data_ptr(), cpool.data_ptr(),
                kpool.data_ptr(), table.data_ptr(), cp.data_ptr(),
                out.data_ptr(), b, h, PS, table.shape[1], scale, 1,
                stream_ptr(q))
            assert rc == 0, rc
            return out

        def run_new(q=q, q2=q2, lat=lat, kr=kr, cp=cp):
            return attn_decode(q, lat, lat, cp, scale=scale, q2=q2, k2=kr,
                               precise=True)

        def run_paged(q=q, q2=q2, cpool=cpool, kpool=kpool, table=table,
                      cp=cp):
            return attn_decode_paged(q, cpool, cpool, table, cp, scale=scale,
                                     q2=q2, k2_pages=kpool, precise=True)

        rows.append(bits_and_times(
            torch, timer, f"q[{b},{h},{r}]+[{b},{h},{rd}] latent[{b},1,{s},"
            f"{r}] cache_pos {list(cps)}; {mla_plan(b, h, torch.bfloat16)}",
            run_base, run_new, run_paged, run_base_paged))
    return rows


def ab_moe_decode(torch, base, timer):
    """moe_decode, baseline against change at deepseek's shapes (4 live
    slots, one slot, a repeated expert with a dead slot) and jamba's: the
    bits may differ (the two kernels partition the k sums differently), so
    each side is held to the plain version, 1e-4 + 1e-4 |ref| (fp32 on
    both sides); bits equal or not is reported; baseline, change, change,
    baseline are timed."""
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.moe_decode.ops import moe_decode, moe_plan
    from repro_torch.kernels.moe_decode.ref import moe_decode_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def weights(e, d, h):
        return (randn(e, d, h, scale=d ** -0.5),
                randn(e, d, h, scale=d ** -0.5),
                randn(e, h, d, scale=h ** -0.5))

    def routing(b, e, k):
        probs = torch.softmax(randn(b, e, dtype=f32), -1)
        gate, idx = torch.topk(probs, k, dim=-1)
        return (gate / gate.sum(-1, keepdim=True)).contiguous(), \
            idx.to(torch.int32).contiguous()

    def run_base(x, idx, gate, wg, wu, wd):
        (b, d), k, (e, _, h) = x.shape, idx.shape[1], wg.shape
        hidden = torch.empty(b * k, h, dtype=f32, device="cuda")
        tok = torch.empty(b * k, d, dtype=f32, device="cuda")
        out = torch.empty(b, d, dtype=f32, device="cuda")
        rc = base.moe_decode_launch(
            x.data_ptr(), idx.data_ptr(), gate.data_ptr(), wg.data_ptr(),
            wu.data_ptr(), wd.data_ptr(), hidden.data_ptr(), tok.data_ptr(),
            out.data_ptr(), b, k, e, d, h, 1, stream_ptr(x))
        assert rc == 0, base.kernel_error_string(rc)
        return out

    rows = []
    for model, (e, k, d, h) in (("deepseek", (64, 6, 2048, 1408)),
                                ("jamba", (16, 2, 4096, 14336))):
        w = weights(e, d, h)
        gate, idx = routing(4, e, k)
        dead_gate, dead_idx = gate.clone(), idx.clone()
        dead_idx[0, 1] = dead_idx[0, 0]          # a repeated expert
        dead_gate[3] = 0.0                       # a dead slot
        cases = [("4 live slots", randn(4, d), gate, idx)]
        if model == "deepseek":
            cases += [("1 slot", randn(1, d), gate[:1].contiguous(),
                       idx[:1].contiguous()),
                      ("repeated expert, dead slot", randn(4, d), dead_gate,
                       dead_idx)]
        for what, x, g, i in cases:
            want = moe_decode_ref(x, i, g, *w)
            got = {"baseline": run_base(x, i, g, *w),
                   "change": moe_decode(x, i, g, *w)}
            torch.cuda.synchronize()
            errs, ok = {}, True
            for side, out in got.items():
                err = (out - want).abs()
                errs[side] = float(err.max())
                ok = ok and bool((err <= 1e-4 + 1e-4 * want.abs()).all())
            t = [timer(fn, iters=20) for fn in (
                lambda: run_base(x, i, g, *w),
                lambda: moe_decode(x, i, g, *w),
                lambda: moe_decode(x, i, g, *w),
                lambda: run_base(x, i, g, *w))]
            touched = int(torch.unique(i[g != 0]).numel())
            row = dict(shape=f"x[{x.shape[0]},{d}] top-{k} of {e} experts "
                       f"[{d},{h}], {what} ({touched} experts read); "
                       f"{moe_plan(d, h)}", within_tol=ok,
                       bits_equal=torch.equal(got["baseline"],
                                              got["change"]),
                       max_abs_err_baseline=errs["baseline"],
                       max_abs_err_change=errs["change"],
                       baseline_ms=[t[0], t[3]], change_ms=[t[1], t[2]])
            print(json.dumps(row), flush=True)
            rows.append(row)
        del w
        torch.cuda.empty_cache()
    return rows


def ab_mlstm(torch, base, timer):
    """mlstm_decode, baseline against change at xlstm-350m's serving shape
    (4 slots, 4 heads, dh 512) and at one slot: C', n' and m' must keep
    the baseline's bits (``bits_equal``, required); h is held on each side
    to the plain version (1e-4 of the largest |h| + 1e-4 |ref|), its bits
    equal or not beside it; baseline, change, change, baseline are timed
    (cold L2), and traced for the device's own time a call; so is a
    PyTorch copy of C, the same bytes moved."""
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.ssm_decode.ops import mlstm_decode
    from repro_torch.kernels.ssm_decode.ref import mlstm_decode_ref

    gen = torch.Generator(device="cuda").manual_seed(10)
    f32 = torch.float32
    h, dh = 4, 512

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def run_base(q, k, v, li, lf, m, c, n):
        b = q.shape[0]
        h_out, c_new, n_new = (torch.empty_like(q), torch.empty_like(c),
                               torch.empty_like(n))
        m_new = torch.empty_like(m)
        rc = base.mlstm_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
            lf.data_ptr(), m.data_ptr(), c.data_ptr(), n.data_ptr(),
            h_out.data_ptr(), c_new.data_ptr(), n_new.data_ptr(),
            m_new.data_ptr(), b, h, dh, stream_ptr(q))
        assert rc == 0, base.kernel_error_string(rc)
        return h_out, (c_new, n_new, m_new)

    rows = []
    for b in (4, 1):
        # the cell's scales, as chip_smoke.py's check_xlstm draws them
        q, v = randn(b, h, dh), randn(b, h, dh)
        k = randn(b, h, dh, scale=dh ** -0.5)
        li = randn(b, h)
        lf = torch.nn.functional.logsigmoid(3 + randn(b, h))
        m = torch.rand(b, h, generator=gen, device="cuda", dtype=f32) * 6 - 4
        c = randn(b, h, dh, dh, scale=4 * dh ** -0.5)
        n = randn(b, h, dh, scale=4 * dh ** -0.5)
        args = (q, k, v, li, lf, m, c, n)
        want_h = mlstm_decode_ref(*args)[0]
        got = {"baseline": run_base(*args), "change": mlstm_decode(*args)}
        torch.cuda.synchronize()
        h_scale = float(want_h.abs().max())
        errs, ok = {}, True
        for side, (h_out, _) in got.items():
            err = (h_out - want_h).abs()
            errs[side] = float(err.max())
            ok = ok and bool((err <= 1e-4 * h_scale + 1e-4 * want_h.abs()
                              ).all())
        state_equal = all(torch.equal(x, y) for x, y in zip(
            got["baseline"][1], got["change"][1]))
        fns = (lambda: run_base(*args), lambda: mlstm_decode(*args),
               lambda: mlstm_decode(*args), lambda: run_base(*args))
        t = [timer(fn, iters=20) for fn in fns]
        tr = [traced_us(torch, fn, "mlstm_decode_kernel", 20,
                        timer.flush.zero_) for fn in fns]
        # a yardstick that moves the same bytes: PyTorch's copy of C
        c_copy = torch.empty_like(c)
        copy_ms = timer(lambda: c_copy.copy_(c), iters=20)
        copy_us = traced_us(torch, lambda: c_copy.copy_(c), "Memcpy", 20,
                            timer.flush.zero_)
        row = dict(shape=f"q[{b},{h},{dh}] C[{b},{h},{dh},{dh}] fp32",
                   within_tol=ok, bits_equal=state_equal, bits_required=True,
                   h_bits_equal=torch.equal(got["baseline"][0],
                                            got["change"][0]),
                   max_abs_err_h_baseline=errs["baseline"],
                   max_abs_err_h_change=errs["change"], h_scale=h_scale,
                   baseline_ms=[t[0], t[3]], change_ms=[t[1], t[2]],
                   traced_us_baseline=[tr[0], tr[3]],
                   traced_us_change=[tr[1], tr[2]], copy_ms=copy_ms,
                   copy_traced_us=copy_us)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ab_mamba(torch, base, timer):
    """mamba_decode (the Mamba mode of ssm_decode), baseline against
    change at jamba-v0.1-52b's serving shape (4 slots, d_inner 8192,
    d_state 16, fp32) and at one slot: y and h' must keep the baseline's
    bits (``bits_equal``, required), this checkout's step written in place
    (``out=h``, as the mixer calls it) too, and each side is held to the
    plain version (1e-4 + 1e-4 |ref|); baseline, change, change in place,
    change in place, change, baseline are timed (cold L2) and traced for
    the device's own time a call; so is a PyTorch copy of h, which moves
    the same bytes."""
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.ssm_decode.ops import ssm_decode
    from repro_torch.kernels.ssm_decode.ref import mamba_decode_ref

    gen = torch.Generator(device="cuda").manual_seed(12)
    f32 = torch.float32
    din, n = 8192, 16
    # the mixer's scales: A = -exp(a_log) with a_log = log(1..N), dt in
    # [1e-3, 0.1], x the conv + silu output, D = 1
    a = -torch.exp(torch.log(torch.arange(
        1, n + 1, dtype=f32, device="cuda"))).repeat(din, 1)
    dsk = torch.ones(din, dtype=f32, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def run_base(x, g, b, c, h):
        y, h_new = torch.empty_like(x), torch.empty_like(h)
        rc = base.mamba_decode_launch(
            x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dsk.data_ptr(), h.data_ptr(), y.data_ptr(),
            h_new.data_ptr(), x.shape[0], din, n, stream_ptr(x))
        assert rc == 0, base.kernel_error_string(rc)
        return y, h_new

    rows = []
    for bsz in (4, 1):
        x = torch.nn.functional.silu(randn(bsz, din))
        g = torch.rand(bsz, din, generator=gen, device="cuda") * 0.099 + 1e-3
        b, c = randn(bsz, n), randn(bsz, n)
        h = randn(bsz, din, n)
        args = (x, g, a, b, c, dsk, h)
        want = mamba_decode_ref(*args)
        got = {"baseline": run_base(x, g, b, c, h),
               "change": ssm_decode(*args)}
        torch.cuda.synchronize()
        errs, ok = {}, True
        for side, outs in got.items():
            errs[side] = []
            for o, w in zip(outs, want):
                err = (o - w).abs()
                errs[side].append(float(err.max()))
                ok = ok and bool((err <= 1e-4 + 1e-4 * w.abs()).all())
        h_in = h.clone()
        in_place = ssm_decode(*args[:-1], h_in, out=h_in)
        bits = all(torch.equal(p, q) for side in ("change", "in place")
                   for p, q in zip(got["baseline"], {
                       "change": got["change"], "in place": in_place}[side]))
        # the state in place moves on call by call, as in the serve runs
        fns = (lambda: run_base(x, g, b, c, h), lambda: ssm_decode(*args),
               lambda: ssm_decode(*args[:-1], h_in, out=h_in),
               lambda: ssm_decode(*args[:-1], h_in, out=h_in),
               lambda: ssm_decode(*args), lambda: run_base(x, g, b, c, h))
        t = [timer(fn, iters=20) for fn in fns]
        tr = [traced_us(torch, fn, "mamba_decode_kernel", 20,
                        timer.flush.zero_) for fn in fns]
        h_copy = torch.empty_like(h)
        copy_ms = timer(lambda: h_copy.copy_(h), iters=20)
        copy_us = traced_us(torch, lambda: h_copy.copy_(h), "Memcpy", 20,
                            timer.flush.zero_)
        row = dict(shape=f"x[{bsz},{din}] h[{bsz},{din},{n}] fp32",
                   within_tol=ok, bits_equal=bits, bits_required=True,
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   baseline_ms=[t[0], t[5]], change_ms=[t[1], t[4]],
                   in_place_ms=[t[2], t[3]],
                   traced_us_baseline=[tr[0], tr[5]],
                   traced_us_change=[tr[1], tr[4]],
                   traced_us_in_place=[tr[2], tr[3]], copy_ms=copy_ms,
                   copy_traced_us=copy_us)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def ab_scan(torch, base, timer):
    """ssm_scan, baseline against change at jamba-v0.1-52b's prefill (one
    prompt of 20, 57 and 120 tokens, d_inner 8192, d_state 16, bf16 u, dt,
    B, C; with h0 as the engine passes it, and at 120 also without): y and
    h_T must keep the baseline's bits (required), each side held to the
    plain version (y one bf16 ulp, h_T 1e-4 + 1e-4 |ref|); baseline,
    change, change, baseline are timed (cold L2) and traced."""
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    din, n = 8192, 16
    a = -torch.exp(torch.log(torch.arange(
        1, n + 1, dtype=f32, device="cuda"))).repeat(din, 1)
    dsk = torch.ones(din, dtype=f32, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def run_base(u, dt, b, c, h0):
        y = torch.empty_like(u)
        h = torch.empty(u.shape[0], din, n, dtype=f32, device="cuda")
        rc = base.ssm_scan_launch(
            u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), dsk.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h.data_ptr(), u.shape[0], u.shape[1], din, n, 1, stream_ptr(u))
        assert rc == 0, base.kernel_error_string(rc)
        return y, h

    rows = []
    for t, with_h0 in ((20, True), (57, True), (120, True), (120, False)):
        u = torch.nn.functional.silu(randn(1, t, din)).to(bf16)
        dt = (torch.rand(1, t, din, generator=gen, device="cuda") * 0.099
              + 1e-3).to(bf16)
        b, c = randn(1, t, n).to(bf16), randn(1, t, n).to(bf16)
        h0 = randn(1, din, n) if with_h0 else None
        args = (u, dt, a, b, c, dsk, h0)
        want = selective_scan_ref(*args)
        got = {"baseline": run_base(u, dt, b, c, h0),
               "change": ssm_scan(*args)}
        torch.cuda.synchronize()
        errs, ok = {}, True
        for side, outs in got.items():
            errs[side] = []
            for o, w, tol in zip(outs, want, (1e-2, 1e-4)):
                err = (o.float() - w.float()).abs()
                errs[side].append(float(err.max()))
                ok = ok and bool((err <= tol + tol * w.float().abs()).all())
        bits = all(torch.equal(p, q) for p, q in zip(got["baseline"],
                                                      got["change"]))
        fns = (lambda: run_base(u, dt, b, c, h0), lambda: ssm_scan(*args),
               lambda: ssm_scan(*args), lambda: run_base(u, dt, b, c, h0))
        tm = [timer(fn, iters=20) for fn in fns]
        tr = [traced_us(torch, fn, "ssm_scan_kernel", 20, timer.flush.zero_)
              for fn in fns]
        row = dict(shape=f"u[1,{t},{din}] N={n} bf16"
                   f"{' h0' if with_h0 else ''}", within_tol=ok,
                   bits_equal=bits, bits_required=True,
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   baseline_ms=[tm[0], tm[3]], change_ms=[tm[1], tm[2]],
                   traced_us_baseline=[tr[0], tr[3]],
                   traced_us_change=[tr[1], tr[2]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def traced_us(torch, fn, kernel: str, calls: int, flush=None) -> float:
    """The device's own time a call of ``fn`` in the kernels (or copies)
    whose name holds ``kernel``, by torch.profiler over ``calls`` calls
    (each after ``flush()``, if given); None if the trace shows none. A
    trace that lost some of the calls' events (fewer than ``calls``) is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        tot = cnt = 0
        for e in prof.key_averages():
            if kernel in e.key:
                tot += getattr(e, "self_device_time_total", 0) or 0
                cnt += e.count
        if cnt >= calls:
            return tot / calls
    return None


# (M, d, x dtype, scale dtype, where the serving path calls it)
RMSNORM_CASES = (
    (4, 4096, "bf16", "fp32", "yi-9b / jamba layer norms"),
    (4, 4096, "bf16", "bf16", "yi-9b exit head"),
    (4, 2048, "bf16", "fp32", "deepseek layer norms"),
    (4, 512, "bf16", "fp32", "deepseek kv_norm"),
    (4, 1024, "bf16", "fp32", "xlstm block norms"),
    (16, 512, "fp32", "unit", "xlstm mLSTM head norm"),
    (4, 1024, "fp32", "fp32", "xlstm sLSTM norm"),
    (128, 4096, "bf16", "fp32", "yi-9b prefill of 128 tokens"))
# launches in one CUDA graph (and in one traced run) of the rmsnorm and
# entropy_exit A/Bs
GRAPH_LAUNCHES = 100


def capture(torch, fn):
    """One CUDA graph of GRAPH_LAUNCHES back-to-back calls of ``fn``."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    torch.cuda.synchronize()
    return g


def graph_us(torch, g) -> float:
    """us a launch of graph ``g`` replayed: the median of 11 replays."""
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(11):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3 / GRAPH_LAUNCHES)
    return sorted(times)[5]


def ab_rmsnorm(torch, base, timer):
    """rmsnorm, baseline against change at every served shape
    (RMSNORM_CASES): each side held to the plain version (one bf16 ulp for
    bf16 outputs, 1e-4 for fp32), bits equal or not reported; the cold-L2
    time of one call, us a launch of a replayed CUDA graph of 100 launches
    and the traced device us a launch, in turns."""
    from repro_torch.kernels._build import DTYPE_CODE, stream_ptr
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plan
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "unit": torch.float32}
    rows = []
    for m, d, xdt, sdt, what in RMSNORM_CASES:
        x = (torch.randn(m, d, generator=gen, device="cuda") * 3).to(dts[xdt])
        sc = (torch.ones(d, device="cuda") if sdt == "unit" else torch.randn(
            d, generator=gen, device="cuda")).to(dts[sdt])
        out = torch.empty_like(x)

        def run_base(x=x, sc=sc, out=out):
            rc = base.rmsnorm_launch(
                x.data_ptr(), sc.data_ptr(), out.data_ptr(), x.shape[0],
                x.shape[1], 1e-5, DTYPE_CODE[x.dtype], DTYPE_CODE[sc.dtype],
                stream_ptr(x))
            assert rc == 0, base.kernel_error_string(rc)
            return out

        def run_new(x=x, sc=sc):
            return rmsnorm(x, sc)

        want = rmsnorm_ref(x, sc).float()
        tol = 1e-2 if x.dtype == torch.bfloat16 else 1e-4
        got = {"baseline": run_base().clone(), "change": run_new()}
        torch.cuda.synchronize()
        errs, ok = {}, True
        for side, o in got.items():
            err = (o.float() - want).abs()
            errs[side] = float(err.max())
            ok = ok and bool((err <= tol + tol * want.abs()).all())
        fns = {"baseline": run_base, "change": run_new}
        graphs = {side: capture(torch, fn) for side, fn in fns.items()}
        order = ("baseline", "change", "change", "baseline")
        g_us = [graph_us(torch, graphs[side]) for side in order]
        cold = [timer(fns[side], iters=20) for side in order]
        tr = [traced_us(torch, fns[side], "rmsnorm_kernel", GRAPH_LAUNCHES)
              for side in order]
        del graphs
        row = dict(shape=f"[{m}, {d}] {xdt} x, {sdt} scale ({what}); "
                   f"{rmsnorm_plan(d, x.dtype)}", within_tol=ok,
                   bits_equal=torch.equal(got["baseline"], got["change"]),
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   graph_us_baseline=[g_us[0], g_us[3]],
                   graph_us_change=[g_us[1], g_us[2]],
                   traced_us_baseline=[tr[0], tr[3]],
                   traced_us_change=[tr[1], tr[2]],
                   baseline_ms=[cold[0], cold[3]],
                   change_ms=[cold[1], cold[2]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# (M, V, logits dtype, the model that serves it)
ENTROPY_CASES = (
    (4, 50304, "bf16", "xlstm-350m"),
    (4, 64000, "bf16", "yi-9b"),
    (4, 65536, "bf16", "jamba-v0.1-52b"),
    (4, 102400, "bf16", "deepseek-v2-lite-16b"),
    (1, 64000, "bf16", "yi-9b, one live slot"),
    (4, 64000, "fp32", "yi-9b, fp32 logits"))


def ab_entropy(torch, base, timer):
    """entropy_exit, baseline against change at every served vocabulary
    (ENTROPY_CASES): each side held to the plain version (1e-4 + 1e-4
    |ref|) and its rows to their M = 1 launches (bitwise), bits equal to
    the baseline's reported; cold-L2 ms, us a launch of a replayed CUDA
    graph of 100 launches and traced device us a launch, in turns; the
    plain version's and the library yardstick's cold ms beside them."""
    from repro_torch.kernels.entropy_exit.ops import entropy
    from repro_torch.kernels.entropy_exit.ref import entropy_ref, log_vocab

    gen = torch.Generator(device="cuda").manual_seed(24)
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    rows = []
    for m, v, dt, what in ENTROPY_CASES:
        x = (torch.randn(m, v, generator=gen, device="cuda") * 3).to(dts[dt])
        out = torch.empty(m, dtype=torch.float32, device="cuda")

        def run_base(x=x, out=out):
            return base_entropy(base, x, out)

        def run_new(x=x):
            return entropy(x)

        want = entropy_ref(x)
        fns = {"baseline": run_base, "change": run_new}
        got, errs, ok, alone = {}, {}, True, True
        for side, fn in fns.items():
            got[side] = fn().clone()
            err = (got[side] - want).abs()
            errs[side] = float(err.max())
            ok = ok and bool((err <= 1e-4 + 1e-4 * want.abs()).all())
            for b in range(m):
                xb = x[b:b + 1].contiguous()
                one = entropy(xb) if side == "change" else base_entropy(
                    base, xb, torch.empty(1, device="cuda"))
                alone = alone and torch.equal(one, got[side][b:b + 1])
        torch.cuda.synchronize()
        graphs = {side: capture(torch, fn) for side, fn in fns.items()}
        order = ("baseline", "change", "change", "baseline")
        g_us = [graph_us(torch, graphs[side]) for side in order]
        cold = [timer(fns[side], iters=20) for side in order]
        tr = [traced_us(torch, fns[side], "entropy_kernel", GRAPH_LAUNCHES)
              for side in order]
        plain_ms = timer(lambda x=x: entropy_ref(x), iters=20)
        lib_ms = timer(lambda x=x, v=v: torch.distributions.Categorical(
            logits=x.float()).entropy() / log_vocab(v), iters=20)
        del graphs
        row = dict(shape=f"[{m}, {v}] {dt} ({what})", within_tol=ok,
                   rows_independent=alone,
                   bits_equal=torch.equal(got["baseline"], got["change"]),
                   max_abs_err_baseline=errs["baseline"],
                   max_abs_err_change=errs["change"],
                   graph_us_baseline=[g_us[0], g_us[3]],
                   graph_us_change=[g_us[1], g_us[2]],
                   traced_us_baseline=[tr[0], tr[3]],
                   traced_us_change=[tr[1], tr[2]],
                   baseline_ms=[cold[0], cold[3]],
                   change_ms=[cold[1], cold[2]],
                   plain_ms=plain_ms, library_ms=lib_ms)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def base_entropy(base, x, out):
    """The baseline's entropy kernel on x [M, V], through its C entry
    point, into ``out`` (fp32 [M])."""
    from repro_torch.kernels._build import DTYPE_CODE, stream_ptr
    from repro_torch.kernels.entropy_exit.ref import log_vocab

    m, v = x.shape
    rc = base.entropy_launch(x.data_ptr(), out.data_ptr(), m, v,
                             log_vocab(v), DTYPE_CODE[x.dtype],
                             stream_ptr(x))
    assert rc == 0, base.kernel_error_string(rc)
    return out


if __name__ == "__main__":
    sys.exit(main())

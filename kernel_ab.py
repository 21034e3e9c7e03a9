#!/usr/bin/env python3
"""Hold this checkout's decode-attention kernel against another
checkout's, on one CUDA card: bit for bit, and timed in turns.

    python3 kernel_ab.py --baseline DIR    # DIR: the root of another checkout

Builds ``DIR/src/repro_torch/csrc/attn_decode.cu`` with this checkout's nvcc
flags into ``build/ab/`` and calls it through its C entry point (the same
``attn_decode_launch`` signature); this checkout's ``attn_decode`` runs
through its wrapper. At each shape (bf16, the serving path's GQA widths)
both must give the same bits, and this checkout's ``attn_decode_paged`` on
the same KV behind a shuffled page table must too. Then baseline, change,
paged, paged, change, baseline are timed (median of 20 cold-L2 calls each,
CUDA events): one JSON line per shape, then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (batch, cache extent, cache_pos per sequence)
SHAPES = ((4, 160, (19, 75, 130, 159)),
          (4, 160, (0, 1, 63, 64)),
          (4, 2048, (100, 1000, 1500, 2047)))
HQ, HKV, D, PS = 32, 4, 128, 16


def build_baseline(baseline: Path) -> ctypes.CDLL:
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    csrc = baseline / "src" / "repro_torch" / "csrc"
    out = ROOT / "build" / "ab" / "attn_decode_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                    str(csrc / "attn_decode.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attn_decode_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                       ctypes.c_float, i, p]
    lib.attn_decode_launch.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA card")
    from chip_smoke import Timer, card_line
    from repro_torch.kernels._build import stream_ptr
    from repro_torch.kernels.attn_decode.ops import attn_decode
    from repro_torch.kernels.paged_attention.ops import attn_decode_paged

    base = build_baseline(args.baseline.resolve())
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for b, s, cps in SHAPES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda"
                               ).to(torch.bfloat16)
        q, k, v = randn(b, HQ, D), randn(b, HKV, s, D), randn(b, HKV, s, D)
        cp = torch.tensor(cps, dtype=torch.int32, device="cuda")

        def run_base(q=q, k=k, v=v, cp=cp, b=b, s=s):
            out = torch.empty(b, HQ, D, dtype=torch.float32, device="cuda")
            rc = base.attn_decode_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cp.data_ptr(),
                out.data_ptr(), b, HQ, HKV, s, D ** -0.5, 1, stream_ptr(q))
            assert rc == 0, rc
            return out

        def run_new(q=q, k=k, v=v, cp=cp):
            return attn_decode(q, k, v, cp)

        # the same KV as pools behind a shuffled page table
        np_ = s // PS
        perm = torch.randperm(b * np_, generator=gen, device="cuda") + 1
        table = perm.view(b, np_).to(torch.int32)
        kp = torch.zeros(b * np_ + 1, HKV, PS, D, dtype=torch.bfloat16,
                         device="cuda")
        vp = torch.zeros_like(kp)
        kp[perm] = k.view(b, HKV, np_, PS, D).transpose(1, 2).reshape(
            b * np_, HKV, PS, D)
        vp[perm] = v.view(b, HKV, np_, PS, D).transpose(1, 2).reshape(
            b * np_, HKV, PS, D)

        def run_paged(q=q, kp=kp, vp=vp, table=table, cp=cp):
            return attn_decode_paged(q, kp, vp, table, cp)

        want = run_base()
        same = torch.equal(run_new(), want)
        same_paged = torch.equal(run_paged(), want)
        torch.cuda.synchronize()
        t = [timer(fn, iters=20) for fn in (run_base, run_new, run_paged,
                                            run_paged, run_new, run_base)]
        row = dict(shape=f"q[{b},{HQ},{D}] kv[{b},{HKV},{s},{D}] "
                   f"cache_pos {list(cps)}", bitwise=same,
                   bitwise_paged=same_paged, baseline_ms=[t[0], t[5]],
                   change_ms=[t[1], t[4]], paged_ms=[t[2], t[3]])
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(card_line())
    ok = all(r["bitwise"] and r["bitwise_paged"] for r in rows)
    print(json.dumps({"ok": ok, "rows": len(rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

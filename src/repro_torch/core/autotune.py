"""Measured XAIF backend autotuning (port of ``repro.core.autotune``).

For every registered op this module enumerates the op's shape buckets
(``xaif.op_buckets``), builds one representative workload per (op, bucket)
cell and times every backend a :class:`~repro_torch.core.xaif.DispatchPolicy`
can name on it (``"kernel"``, ``"ref"`` and the further ones). The winner
of each cell becomes one rule of a policy that is

  * never slower than ``"auto"`` (the kernels) on a cell that has a rule,
    by construction: a cell has a rule only where ``"kernel"`` was
    measured, and the rule is the argmin;
  * JSON-persistable with the device it was measured on: serve startup
    loads the file instead of measuring again (``launch/serve.py --policy
    / --autotune``), and only on that device (:func:`load_policy`).

A cell writes no rule, so that the default ``"kernel"`` stands, where
``"kernel"`` was not measured (its ``supports`` rejected the cell, or the
tensors are on the CPU, where only plain versions ran), and, when an
``arch`` is given, where the cell is a generic one: its fp32 toy shapes
stand for no call of the arch, whose calls in the same bucket may be of
another dtype and run another kernel instance. Such cells are still
timed and reported.

Each op's ``cost_fn`` is the prior: it estimates a cell's flops and bytes
before anything runs, halves the timing loop of heavy cells, and is kept
beside the measurements.

Where this differs from the JAX package:

  * :func:`arch_cells` builds its tensors in the dtypes the served path
    passes (the model's dtype for activations and weights, fp32 where the
    model passes fp32: norm scales, MLA's absorbed query, gates, recurrent
    state), since an fp32 cell would time another kernel instance than the
    one that serves. The generic ``CELLS`` stay fp32, as JAX's;
  * on the card a call is timed by CUDA events (the best of ``iters``,
    after a warm-up call that also builds the kernel's library: no build
    time enters a reading); on the CPU by the host clock;
  * a backend is skipped only where its ``supports`` rejects the cell, or
    where it is ``"kernel"`` on CPU tensors (it would time the plain
    version twice). A backend that raises is not dropped: the exception
    propagates, so that a kernel that fails to build or launch is never
    hidden behind its plain version;
  * no backend declares a tunable (the CUDA kernels derive their plans
    from the shapes; ROADMAP 2.8), so nothing is swept within a backend,
    and the cells are built at one scale.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import xaif
from repro_torch.core.device import resolve_device

DEFAULT_POLICY_PATH = ".xaif_policy_torch.json"

F32 = torch.float32

# ---------------------------------------------------------------------------
# Representative workloads per (op, bucket) cell: build(device) -> (args,
# kwargs), JAX's shapes at its scale 1
# ---------------------------------------------------------------------------


def _randn(shape, seed: int, device, dtype=F32) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _gemm_cell(m: int, k: int = 64, n: int = 64, dtype=F32):
    def build(device):
        return (_randn((m, k), 0, device, dtype),
                _randn((k, n), 1, device, dtype)), {}
    return build


def _rmsnorm_cell(m: int, d: int = 128, dtype=F32):
    def build(device):
        # the model's norm scales are fp32 whatever its dtype
        return (_randn((m, d), 0, device, dtype),
                torch.ones(d, dtype=F32, device=device)), {}
    return build


def _entropy_cell(m: int, v: int = 512, dtype=F32):
    def build(device):
        return (_randn((m, v), 0, device, dtype),), {}
    return build


def _attention_cell(t: int, batch: int = 2, hq: int = 4, hkv: int = 2,
                    s: int = 128, dqk: int = 32, dv: int = 32, dtype=F32):
    def build(device):
        return (_randn((batch, hq, t, dqk), 0, device, dtype),
                _randn((batch, hkv, s, dqk), 1, device, dtype),
                _randn((batch, hkv, s, dv), 2, device, dtype)), {}
    return build


def _ssm_cell(t: int, batch: int = 2, din: int = 32, n: int = 8, dtype=F32):
    def build(device):
        u = _randn((batch, t, din), 0, device, dtype)
        dt = torch.nn.functional.softplus(
            _randn((batch, t, din), 1, device)).to(dtype)
        a = -_randn((din, n), 2, device).abs()
        b = _randn((batch, t, n), 3, device, dtype)
        c = _randn((batch, t, n), 4, device, dtype)
        d = _randn((din,), 5, device)
        return (u, dt, a, b, c, d), {}
    return build


def _ssm_decode_cell(batch: int = 4, din: int = 32, n: int = 8):
    """One mamba-bucket ssm_decode cell (fp32, as the model passes it):
    one token's selective state update at [batch, din]."""
    def build(device):
        x = _randn((batch, din), 0, device)
        g = torch.nn.functional.softplus(_randn((batch, din), 1, device))
        a = -_randn((din, n), 2, device).abs()
        b = _randn((batch, n), 3, device)
        c = _randn((batch, n), 4, device)
        m = _randn((din,), 5, device)
        h = _randn((batch, din, n), 6, device)
        return (x, g, a, b, c, m, h), {}
    return build


def _mlstm_decode_cell(batch: int = 4, heads: int = 4, dh: int = 16):
    """One mlstm-bucket ssm_decode cell (fp32): one token's matrix-LSTM
    update, the state as positional tensors."""
    def build(device):
        qx = _randn((batch, heads, dh), 0, device)
        kx = _randn((batch, heads, dh), 1, device)
        vx = _randn((batch, heads, dh), 2, device)
        li = _randn((batch, heads), 3, device)
        lf = _randn((batch, heads), 4, device)
        m = _randn((batch, heads), 5, device).abs()
        cst = _randn((batch, heads, dh, dh), 6, device)
        nst = _randn((batch, heads, dh), 7, device)
        return (qx, kx, vx, li, lf, m, cst, nst), {}
    return build


def _mla_kwargs(batch, hq, d, rope, key2, device, dtype):
    """The precise (MLA) mode's keywords: fp32 rotary query, the rotary
    key (or its pages) in the model's dtype."""
    return {"scale": (d + rope) ** -0.5,
            "q2": _randn((batch, hq, rope), 3, device),
            key2[0]: _randn(key2[1], 4, device, dtype), "precise": True}


def _attn_decode_cell(s: int, batch: int = 4, hq: int = 4, hkv: int = 2,
                      d: int = 32, mla_rope_dim: int = 0, dtype=F32):
    """One attn_decode cell: ``batch`` sequences of staggered lengths over
    a contiguous [B, Hkv, s, D] cache. ``mla_rope_dim`` > 0 builds the
    MLA absorbed-decode call: one latent head (hkv 1) that is both K and
    V, an fp32 query, the rotary second score component, precise mode."""
    def build(device):
        k = _randn((batch, hkv, s, d), 1, device, dtype)
        pos = ((torch.arange(batch, dtype=torch.int32, device=device)
                * (s // 4) + s // 2) % s).to(torch.int32)
        if mla_rope_dim:
            assert hkv == 1
            q = _randn((batch, hq, d), 0, device)
            return (q, k, k, pos), _mla_kwargs(
                batch, hq, d, mla_rope_dim,
                ("k2", (batch, 1, s, mla_rope_dim)), device, dtype)
        q = _randn((batch, hq, d), 0, device, dtype)
        v = _randn((batch, hkv, s, d), 2, device, dtype)
        return (q, k, v, pos), {}
    return build


def _page_table(batch, np_, ps, pos, k1, device):
    """Slot b owns pages [1 + b NP, 1 + (b + 1) NP); entries past the
    pages its positions reach are -1."""
    table = (1 + torch.arange(batch, device=device)[:, None] * np_
             + torch.arange(np_, device=device)[None, :]).to(torch.int32)
    n_alloc = (pos + k1 - 1) // ps + 1
    live = torch.arange(np_, device=device)[None, :] < n_alloc[:, None]
    return torch.where(live, table, torch.full_like(table, -1))


def _paged_attn_cell(np_pages: int, batch: int = 4, hq: int = 4,
                     hkv: int = 2, d: int = 32, ps: int = 16,
                     mla_rope_dim: int = 0, dtype=F32):
    """One attn_decode_paged cell: ``batch`` sequences of staggered
    lengths over a pool of ``np_pages`` pages each (+ the scratch page);
    ``mla_rope_dim`` > 0: the MLA call on latent pages."""
    def build(device):
        np_, pool = np_pages, batch * np_pages + 1
        kp = _randn((pool, hkv, ps, d), 1, device, dtype)
        pos = ((torch.arange(batch, dtype=torch.int32, device=device) * ps
                + ps // 2) % (np_ * ps)).to(torch.int32)
        table = _page_table(batch, np_, ps, pos, 1, device)
        if mla_rope_dim:
            assert hkv == 1
            q = _randn((batch, hq, d), 0, device)
            return (q, kp, kp, table, pos), _mla_kwargs(
                batch, hq, d, mla_rope_dim,
                ("k2_pages", (pool, 1, ps, mla_rope_dim)), device, dtype)
        q = _randn((batch, hq, d), 0, device, dtype)
        vp = _randn((pool, hkv, ps, d), 2, device, dtype)
        return (q, kp, vp, table, pos), {}
    return build


def _verify_decode_cell(s: int, batch: int = 4, hq: int = 4, hkv: int = 2,
                        d: int = 32, k1: int = 5, dtype=F32):
    """One verify_decode cell: ``k1`` speculative queries a sequence
    against a contiguous [B, Hkv, s, D] cache."""
    def build(device):
        q = _randn((batch, hq, k1, d), 0, device, dtype)
        k = _randn((batch, hkv, s, d), 1, device, dtype)
        v = _randn((batch, hkv, s, d), 2, device, dtype)
        pos = ((torch.arange(batch, dtype=torch.int32, device=device)
                * (s // 4) + s // 2) % (s - k1)).to(torch.int32)
        return (q, k, v, pos), {}
    return build


def _verify_paged_cell(np_pages: int, batch: int = 4, hq: int = 4,
                       hkv: int = 2, d: int = 32, ps: int = 16,
                       k1: int = 5, dtype=F32):
    """One verify_decode_paged cell: ``k1`` queries a sequence over a page
    pool with staggered lengths."""
    def build(device):
        np_, pool = np_pages, batch * np_pages + 1
        q = _randn((batch, hq, k1, d), 0, device, dtype)
        kp = _randn((pool, hkv, ps, d), 1, device, dtype)
        vp = _randn((pool, hkv, ps, d), 2, device, dtype)
        pos = ((torch.arange(batch, dtype=torch.int32, device=device) * ps
                + ps // 2) % (np_ * ps - k1)).to(torch.int32)
        table = _page_table(batch, np_, ps, pos, k1, device)
        return (q, kp, vp, table, pos), {}
    return build


def _moe_decode_cell(e: int, batch: int = 4, k: int = 2, d: int = 64,
                     h: int = 32, dtype=F32):
    """One moe_decode cell: ``batch`` tokens routed top-``k`` over ``e``
    experts through a real softmax top-k (an uneven histogram)."""
    def build(device):
        x = _randn((batch, d), 0, device, dtype)
        wg = (_randn((e, d, h), 1, device) * d ** -0.5).to(dtype)
        wu = (_randn((e, d, h), 2, device) * d ** -0.5).to(dtype)
        wd = (_randn((e, h, d), 3, device) * h ** -0.5).to(dtype)
        logits = _randn((batch, e), 4, device)
        gate, idx = torch.topk(torch.softmax(logits, dim=-1), k)
        gate = gate / gate.sum(dim=-1, keepdim=True)
        return (x, idx.to(torch.int32), gate, wg, wu, wd), {}
    return build


# (op, bucket) -> build(device). One cell for each bucket of every
# built-in op JAX has; ``gemm_heads`` (the port's own op) has none, and an
# op without cells is reported, not silently left untuned
CELLS: Dict[Tuple[str, str], Callable] = {
    ("gemm", "rows_s"): _gemm_cell(8),
    ("gemm", "rows_m"): _gemm_cell(256),
    ("gemm", "rows_l"): _gemm_cell(2304),
    ("rmsnorm", "rows_s"): _rmsnorm_cell(8),
    ("rmsnorm", "rows_m"): _rmsnorm_cell(256),
    ("rmsnorm", "rows_l"): _rmsnorm_cell(2304),
    ("entropy_exit", "rows_s"): _entropy_cell(8),
    ("entropy_exit", "rows_m"): _entropy_cell(256),
    ("entropy_exit", "rows_l"): _entropy_cell(2304),
    ("attention", "decode"): _attention_cell(1),
    ("attention", "prefill"): _attention_cell(128),
    ("ssm_scan", "decode"): _ssm_cell(1),
    ("ssm_scan", "scan"): _ssm_cell(128),
    ("ssm_decode", "mamba"): _ssm_decode_cell(),
    ("ssm_decode", "mlstm"): _mlstm_decode_cell(),
    ("attn_decode", "kv_s"): _attn_decode_cell(128),
    ("attn_decode", "kv_l"): _attn_decode_cell(2048),
    ("attn_decode_paged", "kv_s"): _paged_attn_cell(8),     # 8*16  = 128 kv
    ("attn_decode_paged", "kv_l"): _paged_attn_cell(128),   # 128*16 = 2048
    ("verify_decode", "kv_s"): _verify_decode_cell(128),
    ("verify_decode", "kv_l"): _verify_decode_cell(2048),
    ("verify_decode_paged", "kv_s"): _verify_paged_cell(8),
    ("verify_decode_paged", "kv_l"): _verify_paged_cell(128),
    ("moe_decode", "e_s"): _moe_decode_cell(8),
    ("moe_decode", "e_l"): _moe_decode_cell(64),
}


def arch_cells(cfg, *, capacity: int = 8, bucket_len: int = 64,
               max_len: int = 256,
               page_size: int = 16) -> Dict[Tuple[str, str], Callable]:
    """Cells at one arch's serve-time dims (JAX's shapes): the decode row
    ops at ``capacity`` rows and a prefill of ``bucket_len`` rows at
    d_model / d_ff / vocab, the arch's head layout (MLA's prefill and
    absorbed decode geometry), its KV extent at ``max_len`` in pages of
    ``page_size``, its Mamba / mLSTM / MoE dims. Tensors in the dtypes the
    served path passes. They overlay the generic cells of the buckets they
    land in (``autotune(arch=cfg)``)."""
    dt = getattr(torch, cfg.dtype)
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows_s = min(capacity, 32)
    rows_m = min(max(bucket_len, 33), 2048)
    # MLA archs prefill dqk-wide q/k with a narrower v head and decode on
    # the latent (one shared head, lora-rank wide, a rotary component)
    dqk = hd if cfg.mla is None else (cfg.mla.qk_nope_head_dim
                                      + cfg.mla.qk_rope_head_dim)
    dv = hd if cfg.mla is None else cfg.mla.v_head_dim
    attn_hkv = hkv if cfg.mla is None else hq

    def attention(t, s):
        return _attention_cell(t, batch=capacity, hq=hq, hkv=attn_hkv, s=s,
                               dqk=dqk, dv=dv, dtype=dt)

    cells: Dict[Tuple[str, str], Callable] = {
        ("gemm", "rows_s"): _gemm_cell(rows_s, d, dff, dt),
        ("gemm", "rows_m"): _gemm_cell(rows_m, d, dff, dt),
        ("rmsnorm", "rows_s"): _rmsnorm_cell(rows_s, d, dt),
        ("rmsnorm", "rows_m"): _rmsnorm_cell(rows_m, d, dt),
        ("entropy_exit", "rows_s"): _entropy_cell(rows_s, v, dt),
        ("attention", "decode"): attention(1, max_len),
        ("attention", "prefill"): attention(bucket_len, bucket_len),
    }
    np_ = -(-max_len // page_size)
    kv_extent = np_ * page_size
    kv_bucket = "kv_s" if kv_extent <= 1024 else "kv_l"
    if cfg.mla is None:
        geo = dict(batch=rows_s, hq=hq, hkv=hkv, d=hd, dtype=dt)
        cells[("attn_decode_paged", kv_bucket)] = _paged_attn_cell(
            np_, ps=page_size, **geo)
        cells[("attn_decode", kv_bucket)] = _attn_decode_cell(kv_extent,
                                                              **geo)
        # speculative verify: the same geometry with a K1 query axis (it
        # runs on the standard GQA path only, so no MLA cell)
        cells[("verify_decode", kv_bucket)] = _verify_decode_cell(kv_extent,
                                                                  **geo)
        cells[("verify_decode_paged", kv_bucket)] = _verify_paged_cell(
            np_, ps=page_size, **geo)
    else:
        geo = dict(batch=rows_s, hq=hq, hkv=1, d=cfg.mla.kv_lora_rank,
                   mla_rope_dim=cfg.mla.qk_rope_head_dim, dtype=dt)
        cells[("attn_decode_paged", kv_bucket)] = _paged_attn_cell(
            np_, ps=page_size, **geo)
        cells[("attn_decode", kv_bucket)] = _attn_decode_cell(kv_extent,
                                                              **geo)
    if cfg.mamba is not None:
        from repro_torch.models.mamba import _dims
        d_inner, _, n_state = _dims(cfg)
        cells[("ssm_scan", "decode")] = _ssm_cell(
            1, batch=rows_s, din=d_inner, n=n_state, dtype=dt)
        cells[("ssm_scan", "scan")] = _ssm_cell(
            bucket_len, batch=1, din=d_inner, n=n_state, dtype=dt)
        cells[("ssm_decode", "mamba")] = _ssm_decode_cell(
            batch=rows_s, din=d_inner, n=n_state)
    if cfg.xlstm is not None:
        from repro_torch.models.xlstm import _mlstm_dims
        d_in, dh = _mlstm_dims(cfg)
        cells[("ssm_decode", "mlstm")] = _mlstm_decode_cell(
            batch=rows_s, heads=d_in // dh, dh=dh)
    if cfg.moe is not None:
        moe_bucket = "e_s" if cfg.moe.num_experts <= 16 else "e_l"
        cells[("moe_decode", moe_bucket)] = _moe_decode_cell(
            cfg.moe.num_experts, batch=rows_s, k=cfg.moe.top_k, d=d,
            h=cfg.moe.d_expert, dtype=dt)
    return cells


def _cost_args(op: str, shapes) -> Optional[tuple]:
    """Map cell argument shapes to the op's cost_fn positional dims."""
    try:
        if op == "gemm":
            (xs, ws) = shapes[0], shapes[1]
            m = 1
            for dim in xs[:-1]:
                m *= dim
            return (m, xs[-1], ws[-1])
        if op in ("rmsnorm", "entropy_exit"):
            xs = shapes[0]
            m = 1
            for dim in xs[:-1]:
                m *= dim
            return (m, xs[-1])
        if op == "attention":
            q, k = shapes[0], shapes[1]
            return (q[0], q[1], q[2], k[2], q[3])
        if op == "attn_decode":
            q, ks = shapes[0], shapes[1]
            return (q[0], q[1], ks[2], q[2])
        if op == "attn_decode_paged":
            q, kp, pt = shapes[0], shapes[1], shapes[3]
            return (q[0], q[1], pt[1], kp[2], q[2])
        if op == "verify_decode":
            q, ks = shapes[0], shapes[1]
            return (q[0], q[1], q[2], ks[2], q[3])
        if op == "verify_decode_paged":
            q, kp, pt = shapes[0], shapes[1], shapes[3]
            return (q[0], q[1], q[2], pt[1], kp[2], q[3])
        if op == "moe_decode":
            xs, ks, wg = shapes[0], shapes[1], shapes[3]
            return (xs[0], ks[1], wg[1], wg[2], wg[0])
        if op == "ssm_scan":
            u, a = shapes[0], shapes[2]
            return (u[0], u[1], u[2], a[-1])
        if op == "ssm_decode":
            xs = shapes[0]
            if len(xs) == 2:                    # mamba: x [B, Din], a [Din, N]
                return (xs[0], xs[1], shapes[2][-1])
            return (xs[0], xs[1] * xs[2], xs[2])  # mlstm: x [B, H, dh]
    except (IndexError, TypeError):
        pass
    return None


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _time_call(fn, args, kwargs, iters: int) -> float:
    """Best of ``iters`` calls in microseconds, after one warm-up call
    (which also builds a kernel's library): on a CUDA device by events
    recorded around each call on an idle stream (the host's work between
    the call's launches, which the device waits for, is inside the
    reading); on the CPU by the host clock."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn(*args, **kwargs)
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(max(iters, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _device_kind(dev: torch.device) -> str:
    """What a policy records as the device it was measured on: the card's
    name, or ``"cpu"``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@dataclass
class CellReport:
    """Every measurement taken for one (op, bucket) cell."""

    op: str
    bucket: str
    # the workload's origin: "generic" (CELLS) or an arch name
    # (autotune(arch=...))
    source: str = "generic"
    # backend name -> best measured microseconds
    measured_us: Dict[str, float] = field(default_factory=dict)
    # backend name -> why it was not measured
    skipped: Dict[str, str] = field(default_factory=dict)
    prior: Optional[Dict[str, float]] = None   # cost_fn output for the cell
    shapes: Tuple[Tuple[int, ...], ...] = ()
    dtype: Optional[str] = None
    # the backend the policy names for this cell (the winner), or None
    # with the reason in ``no_rule``: the default "kernel" stands
    rule: Optional[str] = None
    no_rule: str = ""

    def winner(self) -> str:
        return min(self.measured_us, key=self.measured_us.get)


@dataclass
class AutotuneResult:
    policy: xaif.DispatchPolicy
    cells: List[CellReport]
    device: str = "cpu"

    def persist(self, path: str = DEFAULT_POLICY_PATH) -> str:
        """Write the policy JSON, with the device it was measured on (which
        :func:`load_policy` checks) and the measurements (each cell's
        source, shapes, timings, skipped backends, prior and rule), which
        ``DispatchPolicy.from_json`` ignores."""
        meas = [{"op": c.op, "bucket": c.bucket, "source": c.source,
                 "shapes": [list(s) for s in c.shapes], "dtype": c.dtype,
                 "measured_us": c.measured_us, "skipped": c.skipped,
                 "prior": c.prior, "rule": c.rule, "no_rule": c.no_rule}
                for c in self.cells]
        sources = {f"{c.op}/{c.bucket}": c.source for c in self.cells}
        self.policy.save(path, measurements=meas, cell_sources=sources,
                         device=self.device)
        return path


def load_policy(path: str, device="cuda") -> xaif.DispatchPolicy:
    """The policy :meth:`AutotuneResult.persist` wrote, for serving on
    ``device``. Refused unless it was measured there: a policy measured on
    the CPU timed no kernel, one measured on another card chose for that
    card, and a file without a recorded device was not measured."""
    with open(path) as f:
        text = f.read()
    measured_on = json.loads(text).get("device")
    here = _device_kind(resolve_device(device))
    if measured_on != here:
        raise ValueError(
            f"{path}: a dispatch policy measured on {measured_on!r}, not on "
            f"this device ({here!r}); measure one here with --autotune")
    return xaif.DispatchPolicy.from_json(text)


def autotune(ops: Optional[Sequence[str]] = None, *,
             iters: int = 3,
             allow_lossy: bool = False,
             arch=None,
             capacity: int = 8,
             bucket_len: int = 64,
             max_len: int = 256,
             page_size: int = 16,
             device="cuda",
             print_fn: Optional[Callable] = None) -> AutotuneResult:
    """Measure every backend per (op, bucket) cell on ``device``; return
    the :class:`~repro_torch.core.xaif.DispatchPolicy` of the winners
    (default ``"kernel"``) and the report.

    Cells come from ``CELLS``, overlaid by :func:`arch_cells` of ``arch``
    (at ``capacity``, ``bucket_len``, ``max_len``, ``page_size``; each
    such cell's report names the arch); requested ops without a cell are
    reported through ``print_fn``. Lossy backends are left out unless
    ``allow_lossy``. A cell writes a rule only as the module docstring
    says. Exceptions propagate."""
    dev = resolve_device(device)
    want = set(ops) if ops else set(xaif.ops())
    say = print_fn or (lambda *_: None)
    all_cells = dict(CELLS)
    sources = {key: "generic" for key in all_cells}
    if arch is not None:
        overlay = arch_cells(arch, capacity=capacity, bucket_len=bucket_len,
                             max_len=max_len, page_size=page_size)
        all_cells.update(overlay)
        sources.update({key: arch.name for key in overlay})
    uncovered = want - {op for (op, _) in all_cells}
    if uncovered:
        say(f"  WARNING: no measurement cells for ops {sorted(uncovered)} "
            f"- they stay on the policy default")
    reports: List[CellReport] = []
    rules: Dict[Tuple[str, str], str] = {}

    for (op, bucket), build in all_cells.items():
        if op not in want:
            continue
        args, kwargs = build(dev)
        shapes = xaif._shapes_of(args)
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        got = xaif.shape_bucket(op, shapes, dtype)
        assert got == bucket, (op, bucket, got, shapes)
        report = CellReport(op, bucket, source=sources[(op, bucket)],
                            shapes=shapes, dtype=str(dtype))

        # the prior: the cell's work before anything runs; heavy cells
        # take half the timing loop
        cost_fn = xaif.entry(op).cost_fn
        dims = _cost_args(op, shapes)
        if cost_fn is not None and dims is not None:
            report.prior = {k: float(v) for k, v in cost_fn(*dims).items()}
        cell_iters = iters
        if report.prior and report.prior.get("flops", 0) > 1e9:
            cell_iters = max(1, iters // 2)

        for name in xaif.backends_for(op):
            b = xaif.backend(op, name)
            if b.lossy and not allow_lossy:
                report.skipped[name] = "lossy"
                continue
            if not b.accepts(shapes, dtype):
                report.skipped[name] = "supports"
                continue
            fn = b.function(args, kwargs)
            if name == xaif.KERNEL and fn is b.entry.plain:
                # CPU tensors: it would time "ref" a second time
                report.skipped[name] = "cpu: runs the plain version"
                continue
            with torch.inference_mode():
                report.measured_us[name] = _time_call(fn, args, kwargs,
                                                      cell_iters)

        if not report.measured_us:
            say(f"  {op}/{bucket}: nothing measurable, cell skipped")
            continue
        if xaif.KERNEL not in report.measured_us:
            report.no_rule = (f"kernel not measured "
                              f"({report.skipped[xaif.KERNEL]})")
        elif arch is not None and report.source == "generic":
            report.no_rule = f"a generic cell, not {arch.name}'s"
        else:
            report.rule = rules[(op, bucket)] = report.winner()
        win = report.winner()
        say(f"  {op}/{bucket}: {win} {report.measured_us[win]:.0f}us; "
            + (f"rule {report.rule}" if report.rule else
               f"no rule ({report.no_rule}): the default kernel stands"))
        reports.append(report)

    policy = xaif.DispatchPolicy.make(rules, allow_lossy=allow_lossy)
    return AutotuneResult(policy=policy, cells=reports,
                          device=_device_kind(dev))

"""xLSTM mixers, xlstm-350m's sequence mixers (port of
``repro.models.xlstm``): mLSTM (matrix memory, chunkwise-parallel prefill)
and sLSTM (scalar memory, sequential), per Beck et al. 2024
(arXiv:2405.04517).

mLSTM is a linear-attention-class cell with exponential gating:

    C_t = f_t C_{t-1} + i_t k_t v_t^T      (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t            (normalizer)
    h_t = (q_t^T C_t) / max(|n_t . q_t|, exp(-m_t))

with log-domain stabilizer m_t. Prefill runs the chunkwise form (plain
PyTorch, as JAX leaves it to XLA); decode is the O(1) recurrence through
the mLSTM mode of the ``ssm_decode`` op (a hand-written kernel on the
card). sLSTM keeps per-channel scalar memories with the hidden state fed
back into the gates through block-diagonal recurrent weights, so it runs
a sequential Python loop over the tokens.

Every projection goes through the port's ``gemm`` (up_proj, down_proj,
``w_if``, sLSTM's ``wx``, ``w_ff1``, ``w_ff2``) or ``gemm_heads`` (the
block-diagonal q/k/v weights [H, dh, dh] and sLSTM's recurrent ``wr`` [H,
dh, 4 dh], read head-major in place), and both RMS norms (the mLSTM head
norm, the sLSTM output norm) through the ``rmsnorm`` op, where JAX has
plain einsums and means: on the card those kernels reduce each row in one
fixed order whatever the batch, which ``torch.matmul`` and PyTorch's
reductions do not promise, and the serve engine's token equality with
``generate`` rests on it. States are written into the caller's cache
views in place.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif
from repro_torch.models.layers import (apply_conv1d, dense_init, init_conv1d,
                                       normal_init)

_NEG = -1e30


class MLSTMState(NamedTuple):
    c: torch.Tensor            # [(L,) B, H, dh, dh] fp32
    n: torch.Tensor            # [(L,) B, H, dh] fp32
    m: torch.Tensor            # [(L,) B, H] fp32 (log-domain stabilizer)
    conv: torch.Tensor         # [(L,) B, K-1, d_in] activation dtype


class SLSTMState(NamedTuple):
    c: torch.Tensor            # [(L,) B, d] fp32
    n: torch.Tensor            # [(L,) B, d] fp32
    h: torch.Tensor            # [(L,) B, d] fp32
    m: torch.Tensor            # [(L,) B, d] fp32


def _mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    d_in = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    return d_in, d_in // cfg.num_heads


@functools.lru_cache(maxsize=16)
def _ones(d: int, device: torch.device) -> torch.Tensor:
    """The unit scale of the mLSTM head norm (JAX's has no weight)."""
    return torch.ones(d, dtype=torch.float32, device=device)


def _rounded(scale: float, dtype) -> float:
    """``scale`` as JAX multiplies it into an array of ``dtype``: a Python
    float is weakly typed there, so it is first rounded to ``dtype``."""
    return float(torch.tensor(scale, dtype=dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
               device) -> Dict:
    """Random parameters from ``gen``, from the JAX package's
    distributions: projections N(0, 1 / fan_in), the block-diagonal q/k/v
    [H, dh, dh] N(0, 1 / dh), fp32 gate projection ``w_if`` [d_in, 2 H]
    (column 2j is head j's input gate, 2j + 1 its forget gate), ``b_f =
    3`` (bias toward remembering)."""
    d, h = cfg.d_model, cfg.num_heads
    d_in, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "up_proj": dense_init(gen, d, 2 * d_in, dtype, device),  # x, z-gate
        "conv": init_conv1d(gen, d_in, cfg.xlstm.conv_kernel, dtype, device),
        "wq": normal_init(gen, (h, dh, dh), dh, dtype, device),
        "wk": normal_init(gen, (h, dh, dh), dh, dtype, device),
        "wv": normal_init(gen, (h, dh, dh), dh, dtype, device),
        "w_if": dense_init(gen, d_in, 2 * h, f32, device),
        "b_i": torch.zeros(h, dtype=f32, device=device),
        "b_f": torch.full((h,), 3.0, dtype=f32, device=device),
        "norm_scale": torch.ones(d_in, dtype=f32, device=device),
        "down_proj": dense_init(gen, d_in, d, dtype, device),
    }


def init_mlstm_state(cfg: ArchConfig, batch: int, dtype, device,
                     layers: int) -> MLSTMState:
    """Zeroed states of ``layers`` mLSTM layers, stacked [layers, B, ...]:
    c, n, m fp32, the conv window in ``dtype``."""
    d_in, dh = _mlstm_dims(cfg)
    h = cfg.num_heads

    def z(*shape, dt=torch.float32):
        return torch.zeros(layers, batch, *shape, dtype=dt, device=device)

    return MLSTMState(z(h, dh, dh), z(h, dh), z(h),
                      z(cfg.xlstm.conv_kernel - 1, d_in, dt=dtype))


def _heads(x: torch.Tensor, w: torch.Tensor, policy: str) -> torch.Tensor:
    """x [B, T, H, K] @ the block-diagonal w [H, K, N] -> [B, H, T, N] in
    x's dtype: ``gemm_heads`` on x upcast exactly to fp32, the fp32 result
    rounded once (JAX's einsum in x's dtype)."""
    b, t, h, k = x.shape
    out = xaif.call("gemm_heads", policy,
                    x.reshape(b * t, h, k).float().contiguous(), w,
                    head_major=True)
    return out.to(x.dtype).reshape(b, t, h, -1).transpose(1, 2)


def _mlstm_qkv_gates(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                     state_conv: Optional[torch.Tensor]):
    """Shared projections. x [B, T, d] -> q, k, v [B, H, T, dh] in x's
    dtype, logi / logf [B, H, T] fp32, the z-gate [B, T, d_in] and the new
    conv window. q and k come from the conv + silu output, v from the
    pre-conv activation."""
    b, t, _ = x.shape
    h = cfg.num_heads
    d_in, dh = _mlstm_dims(cfg)
    xz = xaif.call("gemm", policy, x, params["up_proj"])
    xi, z = xz[..., :d_in], xz[..., d_in:]
    xc, new_conv = apply_conv1d(params["conv"], xi, state_conv)
    xc = F.silu(xc.float()).to(x.dtype)
    xch = xc.reshape(b, t, h, dh)
    q = _heads(xch, params["wq"], policy)
    k = _heads(xch, params["wk"], policy) * _rounded(dh ** -0.5, x.dtype)
    v = _heads(xi.reshape(b, t, h, dh), params["wv"], policy)
    gates = xaif.call("gemm", policy, xc.float(), params["w_if"])
    gates = gates.reshape(b, t, h, 2).transpose(1, 2)         # [B, H, T, 2]
    logi = gates[..., 0] + params["b_i"][None, :, None]
    logf = F.logsigmoid(gates[..., 1] + params["b_f"][None, :, None])
    return q, k, v, logi, logf, z, new_conv


def _mlstm_out(params, h_out: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor, cfg: ArchConfig, policy: str) -> torch.Tensor:
    """Head norm (``rmsnorm`` with a unit scale over each head's dh, then
    ``norm_scale``), the silu(z) gate and down_proj. h_out fp32 [B, H, T,
    dh]."""
    b, t = z.shape[:2]
    d_in, dh = _mlstm_dims(cfg)
    h_out = xaif.call("rmsnorm", policy, h_out.contiguous(),
                      _ones(dh, h_out.device), eps=cfg.norm_eps)
    h_out = h_out.transpose(1, 2).reshape(b, t, d_in) * params["norm_scale"]
    out = (h_out * F.silu(z.float())).to(x.dtype)
    return xaif.call("gemm", policy, out, params["down_proj"])


def _chunk_len(cfg: ArchConfig, t: int) -> int:
    """The chunk length JAX takes: the configured one, halved until it
    divides T (a prime T runs chunks of 1)."""
    lchunk = min(cfg.xlstm.chunk_size, t)
    while t % lchunk:
        lchunk //= 2
    return lchunk


def apply_mlstm(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                state: Optional[MLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Chunkwise-parallel prefill. x [B, T, d] -> (y [B, T, d], state).
    Within a chunk the pairwise scores are quadratic in the chunk length;
    across chunks the (C, n, m) state carries. With a ``state`` the scan
    starts from it and the final state and conv window are written into
    it, in place."""
    b, t, _ = x.shape
    hh = cfg.num_heads
    d_in, dh = _mlstm_dims(cfg)
    lchunk = _chunk_len(cfg, t)
    q, k, v, logi, logf, z, new_conv = _mlstm_qkv_gates(
        params, x, cfg, policy, None if state is None else state.conv)
    q, k, v = q.float(), k.float(), v.float()
    if state is not None:
        c_prev, n_prev, m_prev = state.c, state.n, state.m
    else:
        c_prev = torch.zeros(b, hh, dh, dh, dtype=torch.float32,
                             device=x.device)
        n_prev = torch.zeros(b, hh, dh, dtype=torch.float32, device=x.device)
        m_prev = torch.zeros(b, hh, dtype=torch.float32, device=x.device)
    tri = torch.ones(lchunk, lchunk, dtype=torch.bool,
                     device=x.device).tril()
    outs = []
    for s in range(0, t, lchunk):
        qx, kx, vx = q[:, :, s:s + lchunk], k[:, :, s:s + lchunk], \
            v[:, :, s:s + lchunk]                             # [B, H, L, dh]
        li, lf = logi[:, :, s:s + lchunk], logf[:, :, s:s + lchunk]
        bcum = torch.cumsum(lf, dim=-1)                       # inclusive decay
        # intra-chunk pairwise log-weights D[t, s] = b_t - b_s + i_s (s <= t)
        dmat = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
        dmat = torch.where(tri, dmat, _NEG)
        # per-step stabilizer: max(inter decay + m_prev, intra row max)
        m_inter = bcum + m_prev[..., None]                    # [B, H, L]
        m_t = torch.maximum(m_inter, dmat.amax(dim=-1))
        w_intra = torch.exp(dmat - m_t[..., None])            # [B, H, L, L]
        w_inter = torch.exp(m_inter - m_t)                    # [B, H, L]
        scores = torch.matmul(qx, kx.transpose(-1, -2)) * w_intra
        h_num = (torch.matmul(scores, vx)
                 + w_inter[..., None] * torch.matmul(qx, c_prev))
        n_dot = (scores.sum(dim=-1) + w_inter
                 * torch.matmul(qx, n_prev[..., None])[..., 0])
        denom = torch.maximum(n_dot.abs(), torch.exp(-m_t))
        outs.append(h_num / denom[..., None])                 # [B, H, L, dh]
        # chunk-end state: C = decay0 C + (w_state k)^T v, no [L, dh, dh]
        m_state = m_t[..., -1]
        w_state = torch.exp(dmat[..., -1, :] - m_state[..., None])
        decay0 = torch.exp(m_inter[..., -1] - m_state)        # [B, H]
        wk = w_state[..., None] * kx                          # [B, H, L, dh]
        c_prev = (decay0[..., None, None] * c_prev
                  + torch.matmul(wk.transpose(-1, -2), vx))
        n_prev = decay0[..., None] * n_prev + wk.sum(dim=-2)
        m_prev = m_state
    out = _mlstm_out(params, torch.cat(outs, dim=2), z, x, cfg, policy)
    if state is not None:
        state.c.copy_(c_prev)
        state.n.copy_(n_prev)
        state.m.copy_(m_prev)
        state.conv.copy_(new_conv)
    return out, state


def apply_mlstm_decode(params, x: torch.Tensor, cfg: ArchConfig,
                       policy: str, state: MLSTMState
                       ) -> Tuple[torch.Tensor, MLSTMState]:
    """O(1) recurrence through the mLSTM mode of ``ssm_decode``. x [B, 1,
    d]; ``state`` is advanced in place."""
    q, k, v, logi, logf, z, new_conv = _mlstm_qkv_gates(
        params, x, cfg, policy, state.conv)

    def first(a):
        return a[:, :, 0].float().contiguous()

    # the step writes C' over C; n' and m' come back new
    h_out, (_, n, m) = xaif.call(
        "ssm_decode", policy, first(q), first(k), first(v), first(logi),
        first(logf), state.m, state.c, state.n, out=state.c)  # [B, H, dh]
    out = _mlstm_out(params, h_out[:, :, None], z, x, cfg, policy)
    state.n.copy_(n)
    state.m.copy_(m)
    state.conv.copy_(new_conv)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
               device) -> Dict:
    """Random parameters from ``gen``, from the JAX package's
    distributions: ``wx`` [d, 4 d] (gates i, f, z, o from x), the fp32
    block-diagonal recurrent ``wr`` [H, dh, 4 dh] N(0, 1 / dh) x 0.1, the
    fp32 bias (forget gate 3, the rest 0) and the gated FFN (proj factor
    4/3: ``w_ff1`` [d, 2 d_ff] with u first and g second, ``w_ff2``)."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    d_ff = int(cfg.xlstm.slstm_proj_factor * d)
    f32 = torch.float32
    return {
        "wx": dense_init(gen, d, 4 * d, dtype, device),
        "wr": normal_init(gen, (h, dh, 4 * dh), dh, f32, device) * 0.1,
        "b": torch.cat([torch.zeros(d, dtype=f32, device=device),
                        torch.full((d,), 3.0, dtype=f32, device=device),
                        torch.zeros(2 * d, dtype=f32, device=device)]),
        "norm_scale": torch.ones(d, dtype=f32, device=device),
        "w_ff1": dense_init(gen, d, 2 * d_ff, dtype, device),
        "w_ff2": dense_init(gen, d_ff, d, dtype, device),
    }


def init_slstm_state(cfg: ArchConfig, batch: int, device,
                     layers: int) -> SLSTMState:
    """Zeroed fp32 states of ``layers`` sLSTM layers, [layers, B, d] each
    (m included)."""
    def z():
        return torch.zeros(layers, batch, cfg.d_model, dtype=torch.float32,
                           device=device)
    return SLSTMState(z(), z(), z(), z())


def _slstm_step(params, x_t: torch.Tensor, st: SLSTMState, policy: str
                ) -> SLSTMState:
    """x_t [B, 4 d] fp32 (pre-projected W x) -> the new state (its h is
    the step's output)."""
    b, d = st.c.shape
    wr = params["wr"]                                     # [H, dh, 4 dh]
    h_, dh = wr.shape[0], wr.shape[1]
    rec = xaif.call("gemm_heads", policy, st.h.reshape(b, h_, dh), wr,
                    head_major=True)                      # [B, H, 4 dh]
    # gate-major: gate g's [B, d] is the g-th dh slice of every head
    rec = rec.reshape(b, h_, 4, dh).transpose(1, 2).reshape(b, 4 * d)
    pre = (x_t + rec) + params["b"]
    li, lf, zt, ot = pre.split(d, dim=-1)
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(lf + st.m, li)
    iw = torch.exp(li - m_new)
    fw = torch.exp(lf + st.m - m_new)
    c = fw * st.c + iw * torch.tanh(zt)
    n = fw * st.n + iw
    h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c, n, h, m_new)


def apply_slstm(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                state: Optional[SLSTMState] = None
                ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Sequential path (a Python loop over T), prefill and decode alike. x
    [B, T, d] -> (y [B, T, d], state). The cell output is RMS-normalized
    (``rmsnorm`` with ``norm_scale``) and goes through the gated FFN. With
    a ``state`` the loop starts from it and the final state is written
    into it, in place."""
    b, t, d = x.shape
    st = state if state is not None else SLSTMState(
        *(s[0] for s in init_slstm_state(cfg, b, x.device, 1)))
    xw = xaif.call("gemm", policy, x, params["wx"]).float()   # [B, T, 4 d]
    hs = []
    for i in range(t):
        st = _slstm_step(params, xw[:, i], st, policy)
        hs.append(st.h)
    h = xaif.call("rmsnorm", policy, torch.stack(hs, dim=1),
                  params["norm_scale"], eps=cfg.norm_eps).to(x.dtype)
    ug = xaif.call("gemm", policy, h, params["w_ff1"])
    d_ff = ug.shape[-1] // 2
    ff = (F.silu(ug[..., d_ff:].float()) * ug[..., :d_ff].float()).to(x.dtype)
    out = xaif.call("gemm", policy, ff, params["w_ff2"])
    if state is not None:
        for dst, src in zip(state, st):
            dst.copy_(src)
    return out, state


def apply_slstm_decode(params, x: torch.Tensor, cfg: ArchConfig,
                       policy: str, state: SLSTMState
                       ) -> Tuple[torch.Tensor, SLSTMState]:
    """One token of ``apply_slstm`` from ``state`` (advanced in place)."""
    return apply_slstm(params, x, cfg, policy, state)

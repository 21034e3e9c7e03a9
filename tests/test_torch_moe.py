"""The port's MoE (``models/moe.py``, the ``moe_decode`` op) against the
JAX package's, from the same seeded numpy inputs and the same parameters.

Tolerances: 1e-5 (relative and absolute) for ``moe_decode``: both sides
compute in fp32 from the same (bf16-rounded where bf16) inputs and differ
only in summation order. 1e-4 for the MoE layers at fp32, as in
``test_torch_model.py``: the expert products go through XLA's and
PyTorch's CPU matmuls. Routing (top-k indices, ranks, drops) is compared
exactly; where two gates tie, top-k may order them differently, so the
selected experts are compared as sets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AccelConfig, get_arch
from repro.kernels._tiling import sorted_run_ranks as jax_sorted_run_ranks
from repro.kernels.moe_decode import moe_decode as jax_md_kernel
from repro.kernels.moe_decode import ref as jax_md_ref
from repro.models import moe as jmoe
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.moe_decode.ref import moe_decode_ref
from repro_torch.models import moe

POLICY = AccelConfig()            # the JAX package's all-ref policy
TOL = 1e-4
TOL_OP = 1e-5


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _configs(dtype="float32", **moe_kw):
    jcfg = get_arch("deepseek-v2-lite-16b").reduced(dtype=dtype)
    pcfg = port_arch("deepseek-v2-lite-16b").reduced(dtype=dtype)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe_kw))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                                 **moe_kw))
    return jcfg, pcfg


def _moe_params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.dtype(jcfg.dtype))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# the moe_decode op
# ---------------------------------------------------------------------------


def _routing(rng, b, k, e, case):
    idx = np.stack([rng.permutation(e)[:k] for _ in range(b)]).astype(
        np.int32)
    gate = rng.random((b, k)).astype(np.float32)
    gate /= gate.sum(-1, keepdims=True)
    if case == "repeated":
        idx[0, 1] = idx[0, 0]              # one row names an expert twice
        idx[2] = idx[2, 0]                 # one row names a single expert
    if case == "zero_gates":
        gate[1] = 0.0                      # a dead slot
        gate[3, 0] = 0.0                   # one assignment of a live slot
    return idx, gate


@pytest.mark.parametrize("case", ["plain", "repeated", "zero_gates"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_matches_jax(dtype, case):
    b, k, e, d, h = 5, 3, 6, 32, 16
    rng = np.random.default_rng(3)
    x, tx = _pair(rng.standard_normal((b, d), np.float32), dtype)
    wg, twg = _pair(rng.standard_normal((e, d, h), np.float32) * d ** -0.5,
                    dtype)
    wu, twu = _pair(rng.standard_normal((e, d, h), np.float32) * d ** -0.5,
                    dtype)
    wd, twd = _pair(rng.standard_normal((e, h, d), np.float32) * h ** -0.5,
                    dtype)
    idx, gate = _routing(rng, b, k, e, case)
    out = moe_decode_ref(tx, torch.from_numpy(idx), torch.from_numpy(gate),
                         twg, twu, twd)
    assert out.dtype == torch.float32 and out.shape == (b, d)
    ji, jg = jnp.asarray(idx), jnp.asarray(gate)
    for want in (jax_md_ref.moe_decode_ref(x, ji, jg, wg, wu, wd),
                 jax_md_kernel.moe_decode_pallas(x, ji, jg, wg, wu, wd,
                                                 interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=TOL_OP, atol=TOL_OP)
    if case == "zero_gates":
        assert not out[1].any()            # a dead slot's output is 0


def test_moe_decode_rows_independent_of_the_batch():
    """Row b of a batched call equals the call on row b alone, bit for
    bit: the serve engine's token equality with ``generate`` rests on it."""
    b, k, e, d, h = 4, 2, 5, 16, 8
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((b, d), np.float32))
    w = [torch.from_numpy(rng.standard_normal(s, np.float32))
         for s in ((e, d, h), (e, d, h), (e, h, d))]
    idx, gate = (torch.from_numpy(a) for a in _routing(rng, b, k, e,
                                                        "plain"))
    full = moe_decode_ref(x, idx, gate, *w)
    for i in range(b):
        one = moe_decode_ref(x[i:i + 1], idx[i:i + 1], gate[i:i + 1], *w)
        assert torch.equal(full[i:i + 1], one)


# ---------------------------------------------------------------------------
# routing core
# ---------------------------------------------------------------------------


def test_sorted_run_ranks_matches_jax():
    rng = np.random.default_rng(5)
    vals = np.sort(rng.integers(0, 5, (3, 17)), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(
        moe.sorted_run_ranks(torch.from_numpy(vals).long()).numpy(),
        np.asarray(jax_sorted_run_ranks(jnp.asarray(vals))))


@pytest.mark.parametrize("masked", [False, True])
def test_ranked_positions_match_jax(masked):
    """Position-in-expert of every (token, k) assignment, with the
    ``valid`` sentinel: invalid tokens take no rank of a real expert."""
    jcfg, pcfg = _configs()
    rng = np.random.default_rng(6)
    g, s, k, e = 2, 9, pcfg.moe.top_k, pcfg.moe.num_experts
    idx = np.stack([[rng.permutation(e)[:k] for _ in range(s)]
                    for _ in range(g)]).astype(np.int32)
    vg = rng.random((g, s)) < 0.6 if masked else None
    want = jmoe._ranked_positions(jnp.asarray(idx), jcfg.moe,
                                  None if vg is None else jnp.asarray(vg))
    got = moe._ranked_positions(torch.from_numpy(idx).long(), pcfg.moe,
                                None if vg is None else torch.from_numpy(vg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if masked:
        # valid tokens rank densely from 0 within each expert
        for gi in range(g):
            for ex in range(e):
                sel = (idx[gi] == ex) & vg[gi][:, None]
                assert sorted(got[gi].numpy()[sel]) == list(range(sel.sum()))


def test_group_capacity_matches_jax():
    jcfg, pcfg = _configs(capacity_factor=0.5)
    for s in (1, 3, 9, 100):
        assert moe._group_capacity(s, pcfg.moe) == \
            jmoe._group_capacity(s, jcfg.moe)


def _same_routing(jx, tx, jcfg, pcfg, jp, pp, row_stable):
    """Route through both packages; gates allclose, indices equal as sets
    where the selected gates tie."""
    _, jg, ji = jmoe._route(jp["router"], jx, jcfg.moe, row_stable)
    _, pg, pi = moe._route(pp["router"], tx, pcfg.moe, "auto", row_stable)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=TOL_OP,
                               atol=TOL_OP)
    np.testing.assert_array_equal(np.sort(pi.numpy(), -1),
                                  np.sort(np.asarray(ji), -1))


# ---------------------------------------------------------------------------
# the MoE layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("renorm_kept", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_apply_moe_capacity_path_matches_jax(renorm_kept, masked):
    """Prefill dispatch with drops forced by a small capacity factor (0.5:
    capacity 3 for 9 tokens x top-2 over 4 experts), with and without a
    valid mask and ``renorm_kept``."""
    jcfg, pcfg = _configs(capacity_factor=0.5, renorm_kept=renorm_kept)
    jp, pp = _moe_params(jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    valid = rng.random((2, 9)) < 0.7 if masked else None
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _same_routing(jx, tx, jcfg, pcfg, jp, pp, row_stable=False)
    jy, jaux = jmoe.apply_moe(jp, jx, jcfg, POLICY,
                              valid=None if valid is None
                              else jnp.asarray(valid))
    py, paux = moe.apply_moe(pp, tx, pcfg, "auto",
                             valid=None if valid is None
                             else torch.from_numpy(valid))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=TOL, atol=TOL)
    drops = int(jmoe.capacity_drop_count(
        jp, jx, jcfg, valid=None if valid is None else jnp.asarray(valid)))
    assert drops > 0, "the test must exercise dropped assignments"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_decode_matches_jax(dtype):
    """The dropless decode path, with a live mask (slot 2 dead)."""
    jcfg, pcfg = _configs(dtype=dtype)
    jp, pp = _moe_params(jcfg)
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.standard_normal((4, 1, jcfg.d_model), np.float32),
                   dtype)
    live = np.array([True, True, False, True])
    _same_routing(jx, tx, jcfg, pcfg, jp, pp, row_stable=True)
    jy, _ = jmoe.apply_moe_decode(jp, jx, jcfg, POLICY,
                                  valid=jnp.asarray(live))
    py = moe.apply_moe_decode(pp, tx, pcfg, "auto",
                              valid=torch.from_numpy(live))
    # bf16: both sides round the same fp32 sums to bf16; one bf16 ulp
    tol = TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(py.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=tol,
                               atol=tol)


def test_apply_moe_decode_live_rows_ignore_dead_slots():
    """A dead slot's hidden state (even NaN) never reaches a live row: the
    live rows keep their bits. (Row independence from the batch size is a
    property of the kernels, asserted on the card by chip_smoke.py; on the
    CPU the plain GEMM is PyTorch's matmul, whose bits may change with the
    row count.)"""
    _, pcfg = _configs()
    _, pp = _moe_params(_configs()[0])
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 1, pcfg.d_model),
                                             np.float32))
    live = torch.tensor([True, False, True, True])
    y = moe.apply_moe_decode(pp, x, pcfg, "auto", valid=live)
    poisoned = x.clone()
    poisoned[1] = float("nan")
    y2 = moe.apply_moe_decode(pp, poisoned, pcfg, "auto", valid=live)
    for i in (0, 2, 3):
        assert torch.equal(y[i], y2[i])
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the kernel's block plan (csrc/moe_decode.cu runs only on the card)
# ---------------------------------------------------------------------------

# (d, h, experts, top-k, experts a 4-slot step touches on the card): the
# served MoE shapes at full width, with the touched counts chip_smoke.py's
# routing reads (PERF.md section 6, row 8)
MOE_SHAPES = {"deepseek-v2-lite-16b": (2048, 1408, 64, 6, 20),
              "jamba-v0.1-52b": (4096, 14336, 16, 2, 5)}
SMS, SMEM_PER_BLOCK = 132, 232448


def test_moe_plan_takes_no_batch_or_k():
    import inspect

    from repro_torch.kernels.moe_decode.ops import moe_plan
    assert list(inspect.signature(moe_plan).parameters) == ["d", "h"]


@pytest.mark.parametrize("model", sorted(MOE_SHAPES))
def test_moe_plan_fits_and_fills_the_card(model):
    """Each pass's shared memory (the ring, the expert bitmap, the
    assignment list) fits the 227 KB a block may have, in bf16 and fp32;
    at a 4-slot step the touched experts' tiles give each pass at least
    two blocks an SM, and one slot's K experts give the up pass (two
    thirds of the bytes) at least one."""
    from repro_torch.kernels.moe_decode.ops import moe_plan, moe_smem
    d, h, e, k, touched = MOE_SHAPES[model]
    plan = moe_plan(d, h)
    for itemsize in (2, 4):
        assert max(moe_smem(itemsize)) <= SMEM_PER_BLOCK, itemsize
    up, down = plan.blocks(touched)
    assert up >= 2 * SMS and down >= 2 * SMS, (model, plan, up, down)
    assert plan.blocks(k)[0] >= SMS, (model, plan)
    assert plan == (-(-h // 64), -(-d // 64))


def _stub_moe(monkeypatch):
    from repro_torch.kernels.moe_decode import ops as md

    calls = []

    class _Lib:
        def moe_decode_launch(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(md, "require_cuda", lambda *a: None)
    monkeypatch.setattr(md, "_lib", lambda: _Lib())
    monkeypatch.setattr(md, "stream_ptr", lambda t: 0)
    return md, calls


def _moe_call(md, b, k=6, e=64, d=2048, h=1408):
    bf = torch.bfloat16
    return md.moe_decode(torch.zeros(b, d, dtype=bf),
                         torch.zeros(b, k, dtype=torch.int32),
                         torch.ones(b, k), torch.zeros(e, d, h, dtype=bf),
                         torch.zeros(e, d, h, dtype=bf),
                         torch.zeros(e, h, d, dtype=bf))


def test_moe_wrapper_passes_one_plan_for_every_batch(monkeypatch):
    """The C entry point's tiles are one constant: whatever B, it gets the
    same integers but B (no plan argument a batch could move), and each
    call counts one launch."""
    md, calls = _stub_moe(monkeypatch)
    seen = set()
    for b in (1, 4, 8):
        before = md.moe_decode.launches
        out = _moe_call(md, b)
        assert out.shape == (b, 2048) and out.dtype == torch.float32
        assert md.moe_decode.launches == before + 1
        args = calls[-1]
        assert len(args) == 16 and args[9] == b
        seen.add(args[10:15])
    assert seen == {(6, 64, 2048, 1408, 1)}


@pytest.mark.parametrize("case", ["d not a multiple of 8", "too many experts",
                                  "too many assignments"])
def test_moe_wrapper_refuses_what_the_kernel_does_not_take(case,
                                                           monkeypatch):
    md, calls = _stub_moe(monkeypatch)
    before = md.moe_decode.launches
    kw = {"d not a multiple of 8": dict(d=36, h=16, e=4, k=2),
          "too many experts": dict(d=16, h=16, e=md.MAX_EXPERTS + 1, k=2),
          "too many assignments": dict(d=16, h=16, e=4, k=2)}[case]
    b = md.MAX_ASSIGN // 2 + 1 if case == "too many assignments" else 4
    with pytest.raises(ValueError, match="multiples of 8|experts|assignments"):
        _moe_call(md, b, **kw)
    assert md.moe_decode.launches == before and not calls

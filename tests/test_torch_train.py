"""The port's LM training path against the JAX package's: ``lm_batches``,
the cross-entropy and multi-exit losses, AdamW and its schedule,
``forward_train`` (logits, exit logits, MoE aux) and its gradients, the
chunked head loss, the train step (microbatches, loss chunks, remat), the
trainer and its launcher.

Reduced configs in fp32 on both sides, parameters from JAX's ``init_lm``
through ``params_from_jax`` with the QKV biases and every norm scale drawn
away from 0 / 1 in numpy (JAX's init would hide a missing bias or scale),
inputs from numpy seeds. Tolerances: losses 1e-6 (one op apart), forwards
1e-5, gradients 1e-4 of each leaf's largest (fp32 sums in other orders),
AdamW parameters 1e-5 + 1e-4 |p| and its master and moments 1e-6
relative, train-step losses 1e-5 and the trainer's 20-step history 1e-4
relative. The recurrent archs amplify rounding: a 1e-7 relative change of
the parameters moves the port's own logits by 3.8e-5 (jamba) and 7.5e-4
(xlstm), and xlstm's gradients by 6.0e-3 of a leaf's largest, so jamba's
logits are held to 5e-5, xlstm's to 3e-4 and its gradients to 2e-3 (the
port against JAX read 1.6e-5, 1.1e-4 and 7.3e-4). A capacity-dropping MoE
routes a near-tie by rounding, so the MoE archs' inputs are held to a
top-k margin above 1e-6 (asserted).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (SHAPES_BY_NAME, AccelConfig, RunConfig,
                                get_arch)
from repro.core import early_exit as jee
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
from repro_torch.configs.base import RunConfig as PortRun
from repro_torch.configs.base import SHAPES_BY_NAME as PORT_SHAPES
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import early_exit as ee
from repro_torch.core import xaif
from repro_torch.data import pipeline
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import train

ROOT = Path(__file__).resolve().parents[1]
POLICY = AccelConfig()            # the JAX package's all-ref policy
FWD_TOL = {"jamba-v0.1-52b": 5e-5, "xlstm-350m": 3e-4}   # else 1e-5
GRAD_TOL = {"xlstm-350m": 2e-3}                          # else 1e-4
# reduced overrides that keep what sets each arch apart (musicgen: group 1)
REDUCED = {
    "yi-9b": {}, "chatglm3-6b": {}, "qwen3-moe-30b-a3b": dict(head_dim=32),
    "deepseek-v2-lite-16b": {}, "jamba-v0.1-52b": {}, "xlstm-350m": {},
    "musicgen-medium": dict(num_kv_heads=4),
}
ARCHS = list(REDUCED)
GRAD_ARCHS = ["yi-9b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
              "xlstm-350m"]
B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are thousands of small ops: one intra-op
    thread each (restored after the module). Under the suite's parallel
    workers, threads that wait for a core slow such runs tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, **kw):
    kw = dict(REDUCED[name], dtype="float32", **kw)
    return get_arch(name).reduced(**kw), port_arch(name).reduced(**kw)


def _perturb(tree, rng):
    """The JAX tree (numpy leaves) with the QKV biases and every norm
    ``scale`` / ``norm_scale`` replaced by seeded draws: biases N(0,
    0.5^2), scales 1 + U(-0.5, 0.5)."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        a = np.asarray(node)
        if key in ("bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("scale", "norm_scale"):
            return (1 + rng.uniform(-0.5, 0.5, a.shape)).astype(a.dtype)
        return a
    return walk(tree)


@pytest.fixture(scope="module")
def worlds():
    """name -> (JAX config, port config, host params, JAX params, tokens
    [B, T + 1] int32), built on first use."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, pcfg = _configs(name)
            host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
            host = _perturb(host, np.random.default_rng(ARCHS.index(name)))
            toks = np.random.default_rng(100 + ARCHS.index(name)).integers(
                0, jcfg.vocab_size, (B, T + 1), dtype=np.int32)
            built[name] = (jcfg, pcfg, host,
                           jax.tree_util.tree_map(jnp.asarray, host), toks)
        return built[name]
    return get


def _pairs(jtree, ttree, path=""):
    """(path, JAX leaf, port leaf) of two trees of the same layout."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, np.asarray(jtree, np.float32), ttree


def _np(t):
    return t.detach().float().numpy()


def _topk_margin(probs: torch.Tensor, k: int) -> float:
    """The smallest gap between adjacent router probabilities among a
    token's top k + 1: a gap within rounding would let the two packages
    route the token apart."""
    top = torch.topk(probs.float(), k + 1, dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min())


@pytest.fixture
def route_margins(monkeypatch):
    """Record the top-k margin of every capacity-path routing call."""
    margins = []
    route = moe._route

    def spy(router, xg, m, policy, row_stable=False):
        out = route(router, xg, m, policy, row_stable)
        margins.append(_topk_margin(out[0].detach(), m.top_k))
        return out
    monkeypatch.setattr(moe, "_route", spy)
    return margins


# --------------------------------------------------------------------------
# data, losses, optimizer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,host_id,num_hosts",
                         [(0, 0, 0, 1), (3, 7, 0, 1), (1, 2, 1, 2),
                          (5, 0, 3, 4)])
def test_lm_batches_equal_jax_bitwise(seed, step, host_id, num_hosts):
    kw = dict(seed=seed, start_step=step, host_id=host_id,
              num_hosts=num_hosts)
    want = jpipe.lm_batches(256, 8, 33, **kw)
    got = pipeline.lm_batches(256, 8, 33, **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a["inputs"].dtype == a["labels"].dtype == np.int32
        assert a["inputs"].shape == (8 // num_hosts, 33)
        assert np.array_equal(a["inputs"], b["inputs"])
        assert np.array_equal(a["labels"], b["labels"])
        assert a["step"] == b["step"]


def test_lm_batches_resume_mid_stream_and_prefetch():
    whole = pipeline.lm_batches(64, 4, 16, seed=2)
    stream = [next(whole) for _ in range(6)]
    resumed = pipeline.Prefetcher(pipeline.lm_batches(64, 4, 16, seed=2,
                                                      start_step=3))
    for want, got in zip(stream[3:], resumed):
        assert got["step"] == want["step"]
        assert np.array_equal(got["inputs"], want["inputs"])
    # the labels are the inputs shifted by one
    a = stream[0]
    assert np.array_equal(a["inputs"][:, 1:], a["labels"][:, :-1])


def test_cross_entropy_and_multi_exit_loss_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    exits = [rng.standard_normal((3, 7, 50)).astype(np.float32)
             for _ in range(2)]
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = jee.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = ee.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    cfg = port_arch("yi-9b").early_exit
    jcfg = get_arch("yi-9b").early_exit
    for n_exits, m in ((2, None), (1, mask), (0, None)):
        wl, wm = jee.multi_exit_loss(
            jnp.asarray(logits), tuple(jnp.asarray(e) for e in
                                       exits[:n_exits]),
            jnp.asarray(labels), jcfg, None if m is None else jnp.asarray(m))
        gl, gm = ee.multi_exit_loss(
            torch.from_numpy(logits), tuple(torch.from_numpy(e) for e in
                                            exits[:n_exits]),
            torch.from_numpy(labels), cfg,
            None if m is None else torch.from_numpy(m))
        assert set(gm) == set(wm)
        np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def _mixed_tree(rng):
    """A bf16 / fp32 parameter tree and five gradient trees (numpy)."""
    import ml_dtypes
    shapes = {"w": ((6, 5), ml_dtypes.bfloat16),
              "stack": ((2, 4, 3), ml_dtypes.bfloat16),
              "norm": ((5,), np.float32), "router": ((5, 4), np.float32)}
    params = {k: (rng.standard_normal(s) * 0.5).astype(dt)
              for k, (s, dt) in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)
                  ).astype(dt) for k, (s, dt) in shapes.items()}
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("clip", [1e3, 0.05], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(clip):
    params, grads = _mixed_tree(np.random.default_rng(7))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.init_adamw(jp)
    tp = params_from_jax(params, device="cpu")
    tstate = adamw.init_adamw(tp)
    clipped = []
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jp, jstate, jm = jadamw.adamw_update(jp, jg, jstate, lr=1e-2,
                                             weight_decay=0.1,
                                             grad_clip=clip)
        tp, tstate, tm = adamw.adamw_update(
            tp, params_from_jax(g, device="cpu"), tstate,
            lr=torch.tensor(1e-2), weight_decay=0.1, grad_clip=clip)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        clipped.append(float(jm["grad_norm"]) > clip)
        assert int(tstate.step) == int(jstate.step)
        for k in params:
            assert tp[k].dtype == getattr(torch, str(jp[k].dtype))
            want = np.asarray(jp[k], np.float32)
            np.testing.assert_allclose(_np(tp[k]), want, rtol=1e-4,
                                       atol=1e-5)
            for mine, theirs in ((tstate.master, jstate.master),
                                 (tstate.m, jstate.m), (tstate.v, jstate.v)):
                np.testing.assert_allclose(
                    _np(mine[k]), np.asarray(theirs[k]), rtol=1e-6,
                    atol=1e-6 * float(np.abs(np.asarray(theirs[k])).max()))
    assert all(clipped) if clip < 1 else not any(clipped)


def test_cosine_schedule_matches_jax():
    want = jadamw.cosine_schedule(3e-4, warmup=100, total=10_000)
    got = adamw.cosine_schedule(3e-4, warmup=100, total=10_000)
    for s in (0, 1, 99, 100, 101, 5000, 10_000, 12_000):
        w = float(want(jnp.asarray(s, jnp.int32)))
        g = got(torch.tensor(s, dtype=torch.int32))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=1e-12)


# --------------------------------------------------------------------------
# forward_train and its gradients
# --------------------------------------------------------------------------


def _jax_fwd_loss(jcfg, jp, toks):
    logits, exits, aux = jlm.forward_train(jp, toks[:, :-1], jcfg, POLICY)
    loss, _ = jee.multi_exit_loss(logits, exits, toks[:, 1:],
                                  jcfg.early_exit)
    return loss + aux["aux_loss"], (logits, exits, aux["aux_loss"])


def _port_fwd_loss(pcfg, tp, toks, remat="nothing"):
    logits, exits, aux = lm.forward_train(tp, toks[:, :-1], pcfg, "ref",
                                          remat=remat)
    loss, _ = ee.multi_exit_loss(logits, exits, toks[:, 1:],
                                 pcfg.early_exit)
    return loss + aux["aux_loss"], (logits, exits, aux["aux_loss"])


@pytest.fixture(scope="module")
def jax_grads(worlds):
    """name -> (JAX loss, (logits, exits, aux), gradient tree), built on
    first use."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, _, _, jp, toks = worlds(name)
            fn = jax.jit(jax.value_and_grad(
                lambda p: _jax_fwd_loss(jcfg, p, jnp.asarray(toks)),
                has_aux=True))
            (loss, outs), g = fn(jp)
            built[name] = (loss, outs, jax.device_get(g))
        return built[name]
    return get


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_matches_jax(name, worlds, jax_grads, route_margins):
    jcfg, pcfg, host, jp, toks = worlds(name)
    tp = params_from_jax(host, device="cpu")
    if name in GRAD_ARCHS:          # the gradient's jit computes them too
        logits, exits, aux = jax_grads(name)[1]
    else:
        logits, exits, aux = jax.jit(
            lambda p, x: jlm.forward_train(p, x, jcfg, POLICY))(
                jp, jnp.asarray(toks[:, :-1]))
        aux = aux["aux_loss"]
    with torch.no_grad():
        tl, te, ta = lm.forward_train(tp, torch.from_numpy(toks[:, :-1]),
                                      pcfg, "ref")
    assert tl.shape == (B, T, pcfg.vocab_size) and len(te) == len(exits) == 1
    tol = FWD_TOL.get(name, 1e-5)
    np.testing.assert_allclose(_np(tl), np.asarray(logits), rtol=tol,
                               atol=tol)
    for a, b in zip(te, exits):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(ta["aux_loss"]), float(aux), rtol=1e-5,
                               atol=1e-7)
    if pcfg.moe is not None:
        assert float(ta["aux_loss"]) > 0
        assert route_margins and min(route_margins) > 1e-6, route_margins
    else:
        assert float(ta["aux_loss"]) == 0.0


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_gradients_match_jax(name, worlds, jax_grads, route_margins):
    jcfg, pcfg, host, _, toks = worlds(name)
    jloss, _, jg = jax_grads(name)
    tp = params_from_jax(host, device="cpu")
    for t in lm._leaves(tp):
        t.requires_grad_(True)
    loss, _ = _port_fwd_loss(pcfg, tp, torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    n = 0
    for path, want, got in _pairs(jg, tp):
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(_np(got.grad) - want).max())
        assert err <= GRAD_TOL.get(name, 1e-4) * scale, (name, path, err,
                                                         scale)
        n += 1
    assert n == len(lm._leaves(tp))
    if pcfg.moe is not None:
        assert min(route_margins) > 1e-6, route_margins


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "xlstm-350m"])
def test_remat_gives_the_same_loss_and_gradients_bitwise(name, remat,
                                                         worlds):
    _, pcfg, host, _, toks = worlds(name)
    grads = {}
    for mode in ("nothing", remat):
        tp = params_from_jax(host, device="cpu")
        leaves = lm._leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = _port_fwd_loss(pcfg, tp, torch.from_numpy(toks), mode)
        grads[mode] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (l0, g0), (l1, g1) = grads["nothing"], grads[remat]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_unknown_remat_raises(worlds):
    _, pcfg, host, _, toks = worlds("yi-9b")
    with pytest.raises(ValueError, match="remat"):
        lm.forward_train(params_from_jax(host, device="cpu"),
                         torch.from_numpy(toks[:, :-1]), pcfg, "ref",
                         remat="everything")


# --------------------------------------------------------------------------
# the chunked head loss and the train step
# --------------------------------------------------------------------------


def test_chunked_head_loss_equals_unchunked_and_jax(worlds):
    jcfg, pcfg, host, jp, toks = worlds("yi-9b")
    tp = params_from_jax(host, device="cpu")
    x_in, labels = torch.from_numpy(toks[:, :-1]), torch.from_numpy(
        toks[:, 1:])
    with torch.no_grad():
        h, exit_h, _ = lm.forward_train_hidden(tp, x_in, pcfg, "ref")
        whole, wm = ts.chunked_head_loss(tp, h, labels, pcfg, "ref", T,
                                         exit_h)
        logits, exits, _ = lm.forward_train(tp, x_in, pcfg, "ref")
        ref, rm = ee.multi_exit_loss(logits, exits, labels, pcfg.early_exit)
        np.testing.assert_allclose(float(whole), float(ref), rtol=1e-6)
        for chunk in (8, 4, 6):         # 6: 16 // 6 = 2 chunks of 8
            got, gm = ts.chunked_head_loss(tp, h, labels, pcfg, "ref", chunk,
                                           exit_h)
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
            np.testing.assert_allclose(float(gm["loss_exit0"]),
                                       float(rm["loss_exit0"]), rtol=1e-5)
            jh, jexit, _ = jlm.forward_train_hidden(
                jp, jnp.asarray(toks[:, :-1]), jcfg, POLICY)
            want, jm = jts.chunked_head_loss(jp, jh, jnp.asarray(toks[:, 1:]),
                                             jcfg, POLICY, chunk, jexit)
            assert set(gm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(gm[k]), float(jm[k]),
                                           rtol=1e-5)
        # 14 // 4 = 3 chunks do not divide 14: JAX's reshape fails there
        with pytest.raises(ValueError, match="do not divide"):
            ts.chunked_head_loss(tp, h[:, :14], labels[:, :14], pcfg, "ref",
                                 4, None)


STEP_CASES = {                      # id: (microbatch, loss_chunk, remat)
    "plain": (1, 0, "nothing"),
    "microbatch2": (2, 0, "nothing"),
    "chunk8": (1, 8, "nothing"),
    "remat_full": (1, 0, "full"),
}


def _batches(vocab, n, b=4, t=T):
    it = pipeline.lm_batches(vocab, b, t, seed=3)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def port_steps(worlds):
    """case -> (per-step metrics, final params), the port's five steps of
    reduced yi-9b, built on first use."""
    built = {}

    def get(case):
        if case not in built:
            mb, chunk, remat = STEP_CASES[case]
            _, pcfg, host, _, _ = worlds("yi-9b")
            run = PortRun(pcfg, policy="ref", microbatch=mb,
                          loss_chunk=chunk, remat=remat, learning_rate=1e-2)
            _, step = ts.make_train_step(run)
            tp = params_from_jax(host, device="cpu")
            state = ts.TrainState(tp, adamw.init_adamw(tp))
            hist = []
            for batch in _batches(pcfg.vocab_size, 5):
                state, m = step(state, {
                    "inputs": torch.from_numpy(batch["inputs"]),
                    "labels": torch.from_numpy(batch["labels"])})
                hist.append({k: float(v) for k, v in m.items()})
            built[case] = (hist, state.params, int(state.opt.step))
        return built[case]
    return get


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_five_train_steps_match_jax(case, worlds, port_steps):
    mb, chunk, remat = STEP_CASES[case]
    jcfg, pcfg, host, jp, _ = worlds("yi-9b")
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["train_4k"],
                    accel=POLICY, remat=remat, microbatch=mb,
                    loss_chunk=chunk, learning_rate=1e-2)
    _, jstep = jts.make_train_step(run)
    jstate = jts.TrainState(jp, jadamw.init_adamw(jp))
    jstep = jax.jit(jstep)
    hist, tp, nsteps = port_steps(case)
    assert nsteps == 5
    for i, batch in enumerate(_batches(pcfg.vocab_size, 5)):
        jstate, jm = jstep(jstate, {"inputs": jnp.asarray(batch["inputs"]),
                                    "labels": jnp.asarray(batch["labels"])})
        assert set(hist[i]) == set(jm), (set(hist[i]), set(jm))
        for k, v in jm.items():
            np.testing.assert_allclose(hist[i][k], float(v), rtol=1e-5,
                                       atol=1e-8, err_msg=f"step {i} {k}")
    for path, want, got in _pairs(jax.device_get(jstate.params), tp):
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_remat_full_steps_equal_plain_steps_bitwise(port_steps):
    (h0, p0, _), (h1, p1, _) = port_steps("plain"), port_steps("remat_full")
    assert h0 == h1
    assert all(torch.equal(a, b) for a, b in zip(lm._leaves(p0),
                                                 lm._leaves(p1)))


def test_train_step_under_auto_raises_on_the_card_path(worlds, monkeypatch):
    """On CUDA tensors "auto" would launch a kernel on a tensor that
    requires grad: the step raises there and does not switch to "ref". The
    CPU has no kernel, so the device test is forced to take the kernel
    branch."""
    _, pcfg, host, _, toks = worlds("yi-9b")
    monkeypatch.setattr(xaif, "_version", lambda op, e, plain, args, kw: (
        e.plain if plain else _refuse(op, args, kw)))
    _, step = ts.make_train_step(PortRun(pcfg, policy="auto"))
    tp = params_from_jax(host, device="cpu")
    with pytest.raises(RuntimeError, match="requires grad"):
        step(ts.TrainState(tp, adamw.init_adamw(tp)), {
            "inputs": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])})
    _, step = ts.make_train_step(PortRun(pcfg, policy="ref"))
    step(ts.TrainState(tp, adamw.init_adamw(tp)), {
        "inputs": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:])})
    assert not any(t.requires_grad for t in lm._leaves(tp))


def _refuse(op, args, kw):
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in args + tuple(kw.values())):
        raise RuntimeError(f"{op}: a kernel launch on a tensor that "
                           f"requires grad")
    raise AssertionError(f"{op}: a kernel launch outside autograd")


# --------------------------------------------------------------------------
# the trainer and its launcher
# --------------------------------------------------------------------------


def test_train_history_matches_jax_over_20_steps():
    jcfg, pcfg = _configs("yi-9b")
    jrun = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["train_4k"],
                     accel=POLICY, remat="nothing", learning_rate=1e-2,
                     seed=4)
    want = jtrainer.train(jrun, num_steps=20, batch_override=4,
                          seq_override=T, print_fn=lambda *_: None)
    host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(4), jcfg))
    lines = []
    got = train(PortRun(pcfg, policy="ref", remat="nothing",
                        learning_rate=1e-2, seed=4), num_steps=20,
                batch_override=4, seq_override=T, print_fn=lines.append,
                params=params_from_jax(host, device="cpu"))
    assert set(got) == set(want) == {"loss", "loss_final", "loss_exit0",
                                     "aux_loss", "grad_norm", "lr"}
    for k in ("loss", "loss_final", "loss_exit0", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert len(lines) == 2 and lines[1].startswith("step 20: loss=")


def test_training_learns_and_exit_head_tracks():
    """JAX's ``test_training_learns_and_exit_head_tracks`` on the port:
    100 steps of its config from the port's own init, by its bars."""
    cfg = port_arch("yi-9b").reduced(num_layers=2, d_model=64, vocab_size=64,
                                     num_heads=4, num_kv_heads=2, d_ff=128,
                                     head_dim=16)
    run = PortRun(cfg, policy="ref", shape=PORT_SHAPES["train_4k"],
                  remat="nothing", learning_rate=5e-3)
    h = train(run, num_steps=100, batch_override=8, seq_override=32,
              print_fn=lambda *_: None, device="cpu")
    assert np.mean(h["loss"][-5:]) < np.mean(h["loss"][:5]) * 0.9
    assert np.mean(h["loss_exit0"][-5:]) < np.mean(h["loss_exit0"][:5])


def test_train_refuses_a_checkpoint_dir():
    cfg = port_arch("yi-9b").reduced()
    with pytest.raises(NotImplementedError, match="1.7b"):
        train(PortRun(cfg, policy="ref"), 1, checkpoint_dir="ckpt",
              device="cpu")


def _launch(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "musicgen-medium", "--reduced", *args], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_launcher_trains_on_the_cpu_and_refuses_ckpt():
    res = _launch("--steps", "3", "--batch", "2", "--seq", "16",
                  "--device", "cpu")
    assert res.returncode == 0, res.stderr
    res = _launch("--steps", "3", "--device", "cpu", "--ckpt", "ckpt")
    assert res.returncode == 2 and "1.7b" in res.stderr, res.stderr

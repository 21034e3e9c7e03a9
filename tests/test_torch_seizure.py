"""The paper's seizure workload on the port against the JAX package: the
synthetic EEG pipeline, the CNN and the encoder transformer with their
early exits, training (gradients and Adam steps), evaluation and the
Fig. 3 energy model.

Small configs with the full configs' structure: the CNN at window 256,
4 channels, channels (8, 16, 16, 32); the transformer at window 256,
patch 16 (16 tokens), d_model 64 over 4 heads (head dim 16, as at full
size), 2 layers, d_ff 128. Parameters come from JAX's ``init_*`` through
``params_from_jax``; inputs from ``bio_signal_batch``. Tolerances:
forwards 1e-5 (fp32 on both sides, sums in other orders); gradients 1e-4
of each leaf's largest; five Adam steps: losses 1e-4 relative, parameters
1e-5 + 1e-4 |p| (the step normalises each gradient by its running RMS, so
rounding in a gradient moves its update by the same relative amount).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import early_exit_sweep as jsweep
from benchmarks import runtime_improvements as jfig3
from repro.configs.base import AccelConfig
from repro.core import energy as jenergy
from repro.data import pipeline as jpipe
from repro.kernels.flash_attention.ref import attention_ref as jattention
from repro.models import cnn as jcnn
from repro_torch.configs import paper_seizure_cnn, paper_seizure_transformer
from repro_torch.convert import params_from_jax
from repro_torch.core import energy, xaif
from repro_torch.core.early_exit import normalized_entropy
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import train_early_exit
from repro_torch.models import cnn
from repro_torch.train import early_exit as tr

SMALL = {
    "cnn": dict(in_channels=4, window=256, channels=(8, 16, 16, 32)),
    "transformer": dict(in_channels=4, window=256, patch=16, d_model=64,
                        num_heads=4, d_ff=128, num_layers=2),
}
# kind: (JAX config, init, forward; port config, forward; operating weight)
MODELS = {
    "cnn": (jcnn.SeizureCNNConfig, jcnn.init_cnn, jcnn.forward_cnn,
            cnn.SeizureCNNConfig, cnn.forward_cnn, 0.01),
    "transformer": (jcnn.SeizureTransformerConfig, jcnn.init_transformer,
                    jcnn.forward_transformer, cnn.SeizureTransformerConfig,
                    cnn.forward_transformer, 0.1),
}
PALLAS = AccelConfig(backends={"attention": "pallas", "rmsnorm": "pallas",
                               "gemm": "pallas"}, interpret=True)


def _setup(kind):
    jcfg_t, jinit, jfwd, tcfg_t, tfwd, w = MODELS[kind]
    jcfg, tcfg = jcfg_t(**SMALL[kind]), tcfg_t(**SMALL[kind])
    pj = jax.device_get(jinit(jax.random.PRNGKey(0), jcfg))
    return jcfg, jfwd, pj, tcfg, tfwd, params_from_jax(pj, device="cpu"), w


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
        yield path, np.asarray(jtree), ttree


def _batch(step, size=32, seed=0, window=256, channels=4):
    return pipeline.bio_signal_batch(size, window, channels, seed=seed,
                                     step=step)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,batch,window,channels",
                         [(0, 0, 8, 1024, 18), (1, 3, 16, 256, 4),
                          (7, 11, 32, 512, 18), (0, 299, 64, 64, 2)])
def test_bio_signal_batches_equal_jax_bitwise(seed, step, batch, window,
                                              channels):
    want = next(jpipe.bio_signal_batches(batch, window, channels, seed=seed,
                                         start_step=step))
    got = next(pipeline.bio_signal_batches(batch, window, channels,
                                           seed=seed, start_step=step))
    assert got["inputs"].dtype == np.float32
    assert np.array_equal(got["inputs"], want["inputs"])
    assert np.array_equal(got["labels"], want["labels"])
    assert got["step"] == want["step"] == step


def test_bio_signal_steps_are_the_generators_batches():
    it = jpipe.bio_signal_batches(8, 128, 3, seed=5, start_step=2)
    made = list(pipeline.bio_signal_steps(range(2, 9), 8, 128, 3, seed=5))
    assert [b["step"] for b in made] == list(range(2, 9))
    for b in made:
        want = next(it)
        assert np.array_equal(b["inputs"], want["inputs"])
        assert np.array_equal(b["labels"], want["labels"])


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------


def test_published_configs_equal_jax():
    for port, jax_cfg in ((paper_seizure_cnn.CONFIG, jcnn.SeizureCNNConfig()),
                          (paper_seizure_transformer.CONFIG,
                           jcnn.SeizureTransformerConfig())):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_params_from_jax_is_a_pure_copy(kind):
    """The JAX trees (lists of conv blocks or layers, nested dicts) load
    leaf for leaf, in the JAX package's layout; the port's own init has
    the same tree and shapes."""
    jcfg, _, pj, tcfg, _, pt, _ = _setup(kind)
    init = cnn.init_cnn if kind == "cnn" else cnn.init_transformer
    own = init(tcfg, seed=0, device="cpu")
    for path, a, t in _pairs(pj, pt):
        assert t.dtype == torch.float32 and t.shape == a.shape, path
        assert np.array_equal(t.numpy(), a), path
    for path, a, t in _pairs(pj, own):
        assert t.shape == a.shape and t.device.type == "cpu", path


@pytest.mark.parametrize("policy", ["ref", "pallas"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_forward_matches_jax(kind, policy):
    """Final and exit logits against JAX's forward under its ref backends
    and under its Pallas kernels in interpret mode (heads' gemm, the
    transformer's rmsnorm and non-causal flash attention at head dim 16)."""
    jcfg, jfwd, pj, tcfg, tfwd, pt, _ = _setup(kind)
    x = _batch(0, 16, seed=3)["inputs"]
    lj, (ej,) = jfwd(pj, jnp.asarray(x), jcfg,
                     PALLAS if policy == "pallas" else AccelConfig())
    for pol in ("ref", "auto"):       # on the CPU both run the plain ops
        lt, (et,) = tfwd(pt, torch.from_numpy(x), tcfg, pol)
        assert lt.shape == et.shape == (16, 2)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_head_dim_16_matches_jax(causal):
    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
               for _ in range(3))
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal)
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_normalized_entropy_matches_jax():
    from repro.core.early_exit import normalized_entropy as jentropy
    x = np.random.default_rng(2).standard_normal((5, 7, 3)).astype(
        np.float32) * 3
    for dim in (-1, 1):
        np.testing.assert_allclose(
            normalized_entropy(torch.from_numpy(x), dim).numpy(),
            np.asarray(jentropy(jnp.asarray(x), axis=dim)), rtol=1e-6,
            atol=1e-6)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def _jax_loss(params, x, y, cfg, forward, w):
    """The sweep's loss (``early_exit_sweep._make_train.loss_fn``)."""
    logits, exits = forward(params, x, cfg, AccelConfig())
    wt = jnp.where(y == 1, 4.0, 1.0)
    return (jsweep._weighted_ce(logits, y, wt)
            + w * jsweep._weighted_ce(exits[0], y, wt))


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_first_step_gradients_match_jax(kind):
    jcfg, jfwd, pj, tcfg, tfwd, pt, w = _setup(kind)
    b = _batch(0)
    gj = jax.grad(_jax_loss)(pj, jnp.asarray(b["inputs"]),
                             jnp.asarray(b["labels"]), jcfg, jfwd, w)
    for t in tr.leaves(pt):
        t.requires_grad_(True)
    loss = tr.joint_loss(pt, torch.from_numpy(b["inputs"]),
                         torch.from_numpy(b["labels"]), tcfg, tfwd, w)
    np.testing.assert_allclose(
        float(loss.detach()), float(_jax_loss(pj, jnp.asarray(b["inputs"]),
                                     jnp.asarray(b["labels"]), jcfg, jfwd,
                                     w)), rtol=1e-5)
    gt = dict(zip(map(id, tr.leaves(pt)),
                  torch.autograd.grad(loss, tr.leaves(pt))))
    for path, a, t in _pairs(jax.device_get(gj), pt):
        g = gt[id(t)].numpy()
        assert np.abs(a).max() > 0, path
        np.testing.assert_allclose(g, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(),
                                   err_msg=path)


@pytest.fixture(scope="module", params=sorted(MODELS))
def five_steps(request):
    """Five steps of JAX's jitted sweep step and of the port's step from
    the same parameters and batches: (kind, configs, forwards, both
    trajectories of losses, both trained trees)."""
    kind = request.param
    jcfg, jfwd, pj, tcfg, tfwd, pt, w = _setup(kind)
    step = jsweep._make_train(jcfg, jfwd, None, w)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, pj)
    opt = (zeros, jax.tree_util.tree_map(jnp.zeros_like, pj), 0)
    tstep = tr.make_train_step(tcfg, tfwd, w)
    for t in tr.leaves(pt):
        t.requires_grad_(True)
    topt = tr.adam_state(pt)
    jl, tl = [], []
    for s in range(5):
        b = _batch(s)
        pj, opt, loss = step(pj, opt, jnp.asarray(b["inputs"]),
                             jnp.asarray(b["labels"]))
        jl.append(float(loss))
        tl.append(float(tstep(pt, topt, torch.from_numpy(b["inputs"]),
                              torch.from_numpy(b["labels"]))))
    for t in tr.leaves(pt):
        t.requires_grad_(False)
    return dict(kind=kind, jcfg=jcfg, jfwd=jfwd, tcfg=tcfg, tfwd=tfwd,
                jax_losses=jl, losses=tl, pj=jax.device_get(pj), pt=pt,
                t=topt["t"])


def test_five_train_steps_match_jax(five_steps):
    r = five_steps
    assert r["t"] == 5
    np.testing.assert_allclose(r["losses"], r["jax_losses"], rtol=1e-4)
    for path, a, t in _pairs(r["pj"], r["pt"]):
        assert not t.requires_grad, path
        np.testing.assert_allclose(t.numpy(), a, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("threshold", [0.45, 0.9])
def test_evaluate_matches_jax(five_steps, threshold):
    """Exit rate, F1 and accuracy on 512 windows from seed 1, from the
    same (five-step) parameters; the exit decision goes through the
    ``entropy_exit`` op."""
    r = five_steps
    want = jsweep.evaluate(r["jcfg"], r["pj"], r["jfwd"], threshold,
                           n_eval=512)
    got = tr.evaluate(r["tcfg"], r["pt"], r["tfwd"], threshold, n_eval=512)
    assert got == want


def test_ref_policy_trains_on_the_cpu():
    """The plain path under autograd: the gradient reaches every leaf
    through the XAIF ops (CPU tensors take the plain versions under either
    policy) and the loss falls over a few steps."""
    cfg = cnn.SeizureTransformerConfig(**SMALL["transformer"])
    params = cnn.init_transformer(cfg, seed=1, device="cpu")
    for t in tr.leaves(params):
        t.requires_grad_(True)
    b = _batch(0)
    x, y = torch.from_numpy(b["inputs"]), torch.from_numpy(b["labels"])
    loss = tr.joint_loss(params, x, y, cfg, cnn.forward_transformer, 0.1,
                         policy="auto")
    grads = torch.autograd.grad(loss, tr.leaves(params))
    assert all(bool(g.abs().sum() > 0) for g in grads)
    step = tr.make_train_step(cfg, cnn.forward_transformer, 0.1)
    opt = tr.adam_state(params)
    losses = [float(step(params, opt, x, y)) for _ in range(8)]
    assert losses[-1] < 0.5 * losses[0], losses


def test_kernel_launch_under_autograd_raises():
    """``xaif.call`` refuses to launch a kernel (mode "auto", a tensor off
    the CPU) when autograd would need its backward; under no_grad the call
    reaches the kernel wrapper. Meta tensors stand in for the card's."""
    x = torch.empty(4, 64, device="meta", requires_grad=True)
    w = torch.empty(64, 2, device="meta")
    with pytest.raises(RuntimeError, match="'gemm' would launch its CUDA "
                                           "kernel.*requires grad"):
        xaif.call("gemm", "auto", x, w)
    with pytest.raises(RuntimeError, match="'rmsnorm'.*'ref' policy"):
        xaif.call("rmsnorm", "auto", torch.empty(4, 64, device="meta"),
                  torch.empty(64, device="meta", requires_grad=True))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel got "
                                                          "a tensor on meta"):
        xaif.call("gemm", "auto", x, w)
    out = xaif.call("gemm", "ref", x, w)          # the plain version
    assert out.requires_grad and out.shape == (4, 2)
    cpu = xaif.call("gemm", "auto", torch.ones(4, 64, requires_grad=True),
                    torch.ones(64, 2))
    assert cpu.grad_fn is not None


# --------------------------------------------------------------------------
# the energy model (Fig. 3)
# --------------------------------------------------------------------------


def _stage_tuples(stages):
    return [dataclasses.astuple(s) for s in stages]


@pytest.mark.parametrize("size", ["full", "small"])
def test_stage_costs_equal_jax(size):
    kw = (lambda k: SMALL[k]) if size == "small" else (lambda k: {})
    for jfn, tfn, jc, tc, kind in (
            (jcnn.cnn_stage_costs, cnn.cnn_stage_costs,
             jcnn.SeizureCNNConfig, cnn.SeizureCNNConfig, "cnn"),
            (jcnn.transformer_stage_costs, cnn.transformer_stage_costs,
             jcnn.SeizureTransformerConfig, cnn.SeizureTransformerConfig,
             "transformer")):
        js, je = jfn(jc(**kw(kind)))
        ts, te = tfn(tc(**kw(kind)))
        assert _stage_tuples(ts) == _stage_tuples(js) and te == je


@pytest.mark.parametrize("exit_rate", [0.0, 0.5, 0.73, 0.912, 0.988, 1.0])
def test_energy_model_equals_jax(exit_rate):
    for jfn, tfn, jc, tc in (
            (jcnn.cnn_stage_costs, cnn.cnn_stage_costs,
             jcnn.SeizureCNNConfig(), cnn.SeizureCNNConfig()),
            (jcnn.transformer_stage_costs, cnn.transformer_stage_costs,
             jcnn.SeizureTransformerConfig(),
             cnn.SeizureTransformerConfig())):
        (js, je), (ts, te) = jfn(jc), tfn(tc)
        for off in (False, True):
            for ee in (False, True):
                assert energy.run_configuration(ts, exit_rate, te, off, ee) \
                    == jenergy.run_configuration(js, exit_rate, je, off, ee)
        assert energy.improvement_table(ts, exit_rate, te) == \
            jenergy.improvement_table(js, exit_rate, je)
        for st in ts[:2]:
            for tp, jp in ((energy.CPU_PROFILE, jenergy.CPU_PROFILE),
                           (energy.NM_CARUS_PROFILE,
                            jenergy.NM_CARUS_PROFILE)):
                assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
                assert energy.stage_time_energy(st, tp) == \
                    jenergy.stage_time_energy(
                        jenergy.StageCost(*dataclasses.astuple(st)), jp)


@pytest.mark.parametrize("rates", [None, {"transformer": 0.988, "cnn": 0.912},
                                   {"transformer": 0.25, "cnn": 0.6}])
def test_fig3_table_equals_jax(rates):
    assert tr.fig3_table(rates) == jfig3.fig3_table(rates)
    assert tr.PAPER == jfig3.PAPER
    assert tr.PAPER_EXIT_RATES == jfig3.PAPER_EXIT_RATES


def test_f1_score_equals_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        p, y = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
        assert tr.f1_score(p, y) == jsweep.f1_score(p, y)
    zeros = np.zeros(8, int)
    assert tr.f1_score(zeros, zeros) == jsweep.f1_score(zeros, zeros) == 0.0


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------


def test_cli_trains_and_prints_fig3_on_the_cpu(capsys):
    train_early_exit.main(["--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "operating points on cpu" in out
    for kind in ("transformer", "cnn"):
        assert f"{kind} (exit weight" in out and "exit_rate=" in out
    assert "Fig. 3 with measured exit rates" in out
    assert '"nm_offload_early_exit"' in out and '"paper_speedup"' in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_cnn(cnn.SeizureCNNConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.train_model("cnn", 0.01, steps=1)

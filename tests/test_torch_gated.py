"""The port's gated early-exit decode (CALM KV propagation) against the JAX
package's, from the same weights.

``forward_decode_gated`` runs the layers up to the single exit and, when
every live row exits, skips the rest and fills their cache rows from the
exit hidden state. Each arch here exercises a branch of the propagation:
yi-9b plain GQA, chatglm3-6b QKV biases and rotary over half the head dim,
chameleon-34b the K-norm (QK-norm), deepseek-v2-lite-16b MLA latents (with
a dense prefix layer and MoE layers). Each runs ``.reduced(num_layers=4)``
in fp32 on both sides, so the exit sits after layer 1 (deepseek: 2) and
two or three layers are propagated. The biases and norm scales are drawn
away from 0 and 1 (``test_torch_zoo._perturb``), which JAX's init would
hide. Tolerance 1e-4 on logits and on every cache leaf, the propagated
rows included: both sides compute in fp32 and differ in summation order
only. Thresholds: -1 (no row exits: the full path), 2 (every row exits:
the normalized entropy is at most 1) and one between two rows'
entropies; the live masks pick the branch: one live unconfident row
forces the full path, dead rows never veto the skip.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.core.early_exit import normalized_entropy
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.engine import generate as jax_generate
from repro.serve.scheduler import poisson_requests as jax_requests
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig, generate
from repro_torch.serve.scheduler import poisson_requests, serve
from test_torch_zoo import _perturb

TOL = 1e-4
POLICY = AccelConfig()            # the JAX package's all-ref policy
# the JAX side jitted (config and policy static): eager lax.cond / scan
# dispatch op by op and are slow on the CPU
J_PREFILL = jax.jit(jlm.forward_prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(jlm.forward_decode, static_argnums=(2, 3))
J_GATED = jax.jit(jlm.forward_decode_gated, static_argnums=(2, 3))
REDUCED = {"yi-9b": {}, "chatglm3-6b": {}, "chameleon-34b": {},
           "deepseek-v2-lite-16b": {}}
ARCHS = sorted(REDUCED)


def _configs(name, threshold=None):
    kw = dict(REDUCED[name], dtype="float32", num_layers=4)
    out = []
    for cfg in (get_arch(name).reduced(**kw), port_arch(name).reduced(**kw)):
        if threshold is not None:
            cfg = dataclasses.replace(cfg, early_exit=dataclasses.replace(
                cfg.early_exit, entropy_threshold=threshold))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX params, port params), built on first use."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, _ = _configs(name)
            host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
            host = _perturb(host, np.random.default_rng(ARCHS.index(name)))
            built[name] = (jax.tree_util.tree_map(jnp.asarray, host),
                           params_from_jax(host, device="cpu"))
        return built[name]
    return get


@pytest.fixture(scope="module")
def mixed(weights):
    """name -> a threshold between the lowest and the second lowest exit
    entropy of the first decode step: one row exits, two do not."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, pcfg = _configs(name)
            jp, _, jc, _, feed = _prefilled(name, jcfg, pcfg, weights)
            _, ex, _ = J_DECODE(jp, jnp.asarray(feed[0]), jcfg, POLICY,
                                jc)
            ent = np.sort(np.asarray(normalized_entropy(ex[0])))
            assert ent[1] - ent[0] > 1e-3, ent
            built[name] = float(ent[0] + ent[1]) / 2
        return built[name]
    return get


def _np(t):
    return t.float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def _jax_layer(jc, cfg, i):
    """Layer i's state of a JAX LMCache (a prefix layer, or row sb of its
    pattern slot's stack)."""
    if i < cfg.first_k_dense:
        return jc.prefix[i]
    sb, j = divmod(i - cfg.first_k_dense, cfg.period)
    return jax.tree_util.tree_map(lambda a: a[sb], jc.slots[j])


def _caches_close(pc, jc, cfg):
    np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    for i in range(cfg.num_layers):
        for got, want in zip(pc.layer(i), _jax_layer(jc, cfg, i)):
            _close(got, want)


def _prefilled(name, jcfg, pcfg, weights):
    jp, pp = weights(name)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 256, (3, 8), np.int32)
    _, jc = J_PREFILL(jp, jnp.asarray(prompt), jcfg, POLICY,
                      jlm.init_cache(jcfg, 3, 16))
    _, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg, "auto",
                               lm.init_cache(pcfg, 3, 16, device="cpu"))
    return jp, pp, jc, pc, rng.integers(0, 256, (3, 3, 1), np.int32)


# mode: (threshold, live mask or None, branch the JAX cond takes first)
MODES = {"full": (-1.0, [True, False, True], "cont"),
         "exit-all": (2.0, None, "skip"),
         "dead-rows-skip": (-1.0, [False, False, False], "skip"),
         "mixed-one-live-unconfident": ("mixed", [True, True, True], "cont"),
         "mixed-confident-live": ("mixed", "exited", "skip")}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ARCHS)
def test_forward_decode_gated_matches_jax(name, mode, weights, mixed):
    """Two gated steps after a prefill: logits, exit mask and every cache
    leaf (the rows propagated by the skip included) agree with JAX's at
    each step; the first step takes the branch the mode names."""
    threshold, live, branch = MODES[mode]
    if threshold == "mixed":
        threshold = mixed(name)
    jcfg, pcfg = _configs(name, threshold)
    jp, pp, jc, pc, feed = _prefilled(name, jcfg, pcfg, weights)
    for step in range(2):
        tok = feed[step]
        if live == "exited":       # the first step's exiting rows alone
            _, ex, _ = J_DECODE(jp, jnp.asarray(tok), jcfg, POLICY, jc)
            live = (np.asarray(normalized_entropy(ex[0]))
                    < threshold).tolist()
            assert 0 < sum(live) < 3, live
        jlive = None if live is None else jnp.asarray(live)
        plive = None if live is None else torch.tensor(live)
        if step == 0 and branch == "cont":
            full, _, _ = J_DECODE(jp, jnp.asarray(tok), jcfg, POLICY, jc,
                                  live=jlive)
        jlg, jmask, jc = J_GATED(jp, jnp.asarray(tok), jcfg, POLICY, jc,
                                 live=jlive)
        plg, pmask, pc = lm.forward_decode_gated(pp, torch.from_numpy(tok),
                                                 pcfg, "auto", pc, live=plive)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        _close(plg, jlg)
        _caches_close(pc, jc, pcfg)
        if step == 0:
            gate = pmask.numpy() | ~np.asarray(
                [True] * 3 if live is None else live)
            assert ("skip" if gate.all() else "cont") == branch, gate
            if branch == "cont":   # rows not exiting take the final head's
                keep = ~pmask.numpy()
                _close(plg[keep], np.asarray(full)[keep])


def test_gated_and_ungated_agree_where_nothing_is_skipped(weights):
    """At threshold -1 the gated step runs the full path: its logits and
    cache equal the ungated ``forward_decode``'s merged logits, bitwise."""
    _, pcfg = _configs("chatglm3-6b", -1.0)
    jcfg = _configs("chatglm3-6b")[0]
    _, pp, _, pc, feed = _prefilled("chatglm3-6b", jcfg, pcfg, weights)
    ref = lm.LMCache(pc.pos.clone(), pc.mixers, k=pc.k.clone(),
                     v=pc.v.clone())
    for step in range(3):
        tok = torch.from_numpy(feed[step])
        lg, mask, pc = lm.forward_decode_gated(pp, tok, pcfg, "auto", pc)
        full, exits, ref = lm.forward_decode(pp, tok, pcfg, "auto", ref)
        assert not mask.any()
        assert torch.equal(lg, full)
        assert torch.equal(pc.k, ref.k) and torch.equal(pc.v, ref.v)


@pytest.mark.parametrize("threshold", [-1.0, 2.0, "mixed"])
def test_generate_gated_matches_jax(threshold, weights, mixed):
    if threshold == "mixed":
        threshold = mixed("yi-9b")
    jcfg, pcfg = _configs("yi-9b", threshold)
    jp, pp = weights("yi-9b")
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 6), np.int32)
    jtok, jstats = jax_generate(run, jp, jnp.asarray(prompt), 6, gated=True)
    ptok, pstats = generate(pcfg, pp, prompt, 6, device="cpu", gated=True)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    for key in ("exit_rate", "gated_fraction"):
        assert pstats[key] == pytest.approx(jstats[key], abs=1e-6), key


@pytest.mark.parametrize("name,threshold", [
    ("yi-9b", -1.0), ("yi-9b", 2.0), ("yi-9b", 0.905),
    ("deepseek-v2-lite-16b", 0.905)])
def test_gated_slot_engine_matches_jax(name, threshold, weights):
    """One request stream through both gated engines (3 slots, backfill):
    tokens equal request by request, and the exit rate and gated fraction
    equal. 0.905 lies among the exit entropies of these weights, so some
    steps skip and some run the full path."""
    jcfg, pcfg = _configs(name, threshold)
    jp, pp = weights(name)
    kw = dict(capacity=3, max_len=32, chunk=2)
    engine = SlotEngine(pcfg, device="cpu", gated=True, **kw)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    jengine = JaxSlotEngine(run, gated=True, **kw)

    def requests(make):
        return make(num=6, rate_hz=np.inf, prompt_lens=(2, 12),
                    max_new_tokens=(3, 9), vocab_size=256, seed=5)

    reqs, jreqs = requests(poisson_requests), requests(jax_requests)
    report = serve(engine, pp, reqs)
    jreport = jax_serve(jengine, jp, jreqs)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    for key in ("exit_rate", "gated_fraction"):
        assert report.stats[key] == pytest.approx(jreport.stats[key],
                                                  abs=1e-6), key
    if threshold == 2.0:
        el = pcfg.early_exit.exit_layers[0]
        assert report.stats["exit_rate"] == 1.0
        assert report.stats["gated_fraction"] == pytest.approx(
            1 - el / pcfg.num_layers)


def test_gated_engine_request_equals_generate(weights):
    """Every request of a threshold-2 stream equals ``generate(gated=True)``
    on its prompt alone: a skipped step's exit logits depend only on the
    layers before the exit."""
    _, pcfg = _configs("chameleon-34b", 2.0)
    _, pp = weights("chameleon-34b")
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=3, device="cpu",
                        gated=True)
    reqs = poisson_requests(num=4, rate_hz=np.inf, prompt_lens=(2, 10),
                            max_new_tokens=6, vocab_size=256, seed=2)
    serve(engine, pp, reqs)
    for r in reqs:
        want, _ = generate(pcfg, pp, r.prompt[None], 6, device="cpu",
                           gated=True)
        assert r.tokens == want[0].tolist(), r.rid


def test_gated_refusals():
    _, pcfg = _configs("yi-9b")
    kw = dict(capacity=2, max_len=24, device="cpu")
    with pytest.raises(ValueError, match="page-aware"):
        SlotEngine(pcfg, gated=True, paged=True, **kw)
    with pytest.raises(ValueError, match="incompatible with gated"):
        SlotEngine(pcfg, gated=True, spec=SpecConfig(
            draft_arch=pcfg, k=2, share_params=True), **kw)
    plain = dataclasses.replace(pcfg, early_exit=None)
    for name in ("xlstm-350m", "jamba-v0.1-52b"):
        with pytest.raises(ValueError, match="attention-only"):
            SlotEngine(port_arch(name).reduced(), gated=True, **kw)
    with pytest.raises(ValueError, match="exactly one exit"):
        SlotEngine(plain, gated=True, **kw)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    paged = lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")
    with pytest.raises(ValueError, match="page-aware"):
        lm.forward_decode_gated(pp, torch.zeros(2, 1, dtype=torch.int32),
                                pcfg, "auto", paged)


@pytest.mark.parametrize("argv,needle", [
    (["--arch", "yi-9b", "--paged", "--gated"], "page-aware"),
    (["--arch", "yi-9b", "--draft", "yi-9b", "--gated"], "no exit to gate"),
    (["--arch", "xlstm-350m", "--gated"], "attention-only"),
    (["--arch", "jamba-v0.1-52b", "--gated"], "attention-only"),
])
def test_launch_serve_refuses_gated_at_parse_time(capsys, argv, needle):
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(argv + ["--device", "cpu"])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert needle in err and "--gated" in err


def test_launch_serve_gated_cli_on_cpu(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--requests", "3",
                                "--capacity", "2", "--new-tokens", "6",
                                "--max-len", "32", "--device", "cpu",
                                "--gated", "--threshold", "2"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 6 for r in report.requests)
    assert report.stats["exit_rate"] == 1.0
    assert "gated=True" in capsys.readouterr().out

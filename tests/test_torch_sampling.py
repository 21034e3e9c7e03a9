"""The port's sampling (temperature, top-k, top-p, per-slot generators) and
sampled speculative decoding, against the JAX package's definitions and
its sampled-serving properties.

``make_probs`` is held to JAX's over a grid of temperature, top-k and
top-p, on rows with ties at the top, at the k-th value and everywhere
(1e-5 relative: both sides take the same fp32 softmax of the same
truncation; the kept support must be equal). The sampler, fed the same
Gumbel noise, must pick ``argmax(log p_JAX + noise)`` wherever the top two
scores are more than 1e-4 apart. The engine properties are JAX's tests
ported one for one (the port's generators are torch's, so streams are
compared within the port, never with JAX's keys): a seed replays, greedy
ignores top_p and seeds, a seeded request replays across slot placements,
a low temperature collapses to greedy, the tied draft accepts every
proposal, and the plain and speculative samplers' marginals agree within
a total variation of 0.12 (240 seeded requests, as the JAX test).
``spec_accept`` is held to its closed form on a small vocabulary. The
models run in fp32 (``.reduced(dtype="float32")``), where exact logit
ties do not occur, from ``init_lm`` seeds: no JAX weights are needed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import make_probs as jax_make_probs
from repro_torch.configs.base import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import (SlotEngine, SpecConfig, gumbel_noise,
                                      make_probs, make_sampler, spec_accept)
from repro_torch.serve.scheduler import Request, serve

GRID = [(t, k, p) for t in (0.5, 1.0, 1.7) for k in (0, 1, 5, 40)
        for p in (1.0, 0.87, 0.33, 1e-6)]


def _logits(seed, rows=6, v=40):
    rng = np.random.default_rng(seed)
    lg = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    lg[1, [3, 7, 11]] = lg[1].max() + 1.0        # a three-way tie at the top
    lg[2] = np.round(lg[2])                      # ties at the k-th value
    lg[3] = 0.0                                  # every logit tied
    return lg


def _jax_probs(lg, temperature, top_k, top_p):
    probs = jax_make_probs(temperature, top_k, top_p)
    return np.stack([np.asarray(probs(jnp.asarray(row))) for row in lg])


@pytest.mark.parametrize("temperature,top_k,top_p", GRID)
def test_make_probs_matches_jax(temperature, top_k, top_p):
    lg = _logits(0)
    got = make_probs(temperature, top_k, top_p)(torch.from_numpy(lg))
    want = _jax_probs(lg, temperature, top_k, top_p)
    assert got.dtype == torch.float32 and got.shape == lg.shape
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    # batched [2, 3, V] rows are the same rows
    again = make_probs(temperature, top_k, top_p)(
        torch.from_numpy(lg).reshape(2, 3, -1))
    assert torch.equal(again.reshape(got.shape), got)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.87), (0.8, 10, 0.5)])
def test_sampler_with_gumbel_noise_picks_argmax_of_jax_log_probs(
        temperature, top_k, top_p):
    rng = np.random.default_rng(1)
    lg = (2 * rng.standard_normal((64, 50))).astype(np.float32)
    noise = rng.gumbel(size=lg.shape).astype(np.float32)
    got = make_sampler(temperature, top_k, top_p)(torch.from_numpy(lg),
                                                  torch.from_numpy(noise))
    assert got.dtype == torch.int32
    with np.errstate(divide="ignore"):
        score = np.log(_jax_probs(lg, temperature, top_k, top_p)) + noise
    top2 = np.sort(score, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.sum() >= 56, clear.sum()
    np.testing.assert_array_equal(got.numpy()[clear],
                                  score.argmax(-1)[clear])


def test_top_p_sampler_properties():
    """JAX's ``test_top_p_sampler_properties``, with generators for keys."""
    lg = torch.from_numpy(
        (np.random.default_rng(1).normal(size=(64,)) * 3).astype(np.float32))

    def draw(sampler, seed):
        gen = torch.Generator().manual_seed(seed)
        return int(sampler(lg, gumbel_noise([gen], (64,), "cpu")[0]))

    s = make_sampler(1.0, top_p=0.9)
    assert draw(s, 7) == draw(s, 7)                 # deterministic per seed
    assert draw(make_sampler(1.0, top_p=1e-6), 7) == int(lg.argmax())
    probs = torch.softmax(lg, -1).numpy()
    order = np.argsort(-probs)
    keep = (np.cumsum(probs[order]) - probs[order]) < 0.5
    nucleus = set(order[keep].tolist())
    draws = {draw(make_sampler(1.0, top_p=0.5), i) for i in range(50)}
    assert draws <= nucleus and len(draws) > 1
    assert make_sampler(0.0, top_p=0.5) is None
    assert make_probs(0.0, top_k=3) is None


def test_gumbel_noise_rows_come_from_their_own_generator():
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    rows = gumbel_noise(gens, (2, 7), "cpu")
    assert rows.shape == (3, 2, 7) and torch.isfinite(rows).all()
    alone = gumbel_noise([torch.Generator().manual_seed(4)], (2, 7), "cpu")
    assert torch.equal(rows[1], alone[0])


# ---------------------------------------------------------------------------
# the sampled engine (JAX's test_serving_engine / test_prefix_sharing)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def glm():
    cfg = get_arch("chatglm3-6b").reduced(dtype="float32")
    return cfg, lm.init_lm(cfg, seed=0, device="cpu")


def _stream(cfg, n, seed, max_prompt=13, max_new=10, seeds=False):
    rng = np.random.default_rng(seed)
    return [Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size,
                            (int(rng.integers(2, max_prompt)),),
                            dtype=np.int32),
        max_new_tokens=int(rng.integers(2, max_new + 1)),
        seed=int(rng.integers(0, 2**31)) if seeds else None)
        for i in range(n)]


def _serve(cfg, params, reqs, **kw):
    kw = dict(dict(capacity=2, max_len=32, chunk=4), **kw)
    report = serve(SlotEngine(cfg, device="cpu", **kw), params, reqs)
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)
    return report, {r.rid: r.tokens for r in reqs}


def test_sampled_decode_deterministic_and_distinct_from_greedy(glm):
    cfg, params = glm

    def run(**kw):
        return _serve(cfg, params, _stream(cfg, 5, 8), **kw)[1]

    a = run(temperature=0.9, top_k=16, sample_seed=7)
    assert a == run(temperature=0.9, top_k=16, sample_seed=7)
    assert a != run(temperature=0.9, top_k=16, sample_seed=8)
    assert a != run()


def test_greedy_engine_unchanged_by_top_p_and_seeds(glm):
    cfg, params = glm
    outs = []
    for top_p, seeds in ((1.0, None), (0.5, [11, 22, 33, 44])):
        reqs = _stream(cfg, 4, 4)
        for r in reqs:
            r.seed = None if seeds is None else seeds[r.rid]
        outs.append(_serve(cfg, params, reqs, paged=True, page_size=8,
                           top_p=top_p)[1])
    assert outs[0] == outs[1]


def test_engine_never_touches_the_global_generator(glm):
    """Greedy creates no generator; sampled draws only from the per-slot
    generators: the global CPU generator's state is unchanged."""
    cfg, params = glm
    engine = SlotEngine(cfg, capacity=2, max_len=24, chunk=4, device="cpu")
    assert engine.init_state()[1].rng is None
    before = torch.get_rng_state()
    for temperature in (0.0, 0.9):
        _serve(cfg, params, _stream(cfg, 3, 1), temperature=temperature,
               top_k=16)
    assert torch.equal(torch.get_rng_state(), before)


def test_per_request_seed_replays_across_slot_placements(glm):
    cfg, params = glm
    rng = np.random.default_rng(9)
    target = rng.integers(0, cfg.vocab_size, (6,), dtype=np.int32)

    def run(decoys, sample_seed):
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (4,),
                                                   dtype=np.int32),
                        max_new_tokens=6) for i in range(decoys)]
        reqs.append(Request(rid=99, prompt=target, max_new_tokens=6,
                            seed=1234))
        return _serve(cfg, params, reqs, paged=True, page_size=8,
                      temperature=0.8, top_k=8, top_p=0.95,
                      sample_seed=sample_seed)[1][99]

    a = run(decoys=0, sample_seed=0)
    assert a == run(decoys=3, sample_seed=0) == run(decoys=1, sample_seed=77)
    assert len(a) == 6


def test_sampled_low_temperature_collapses_to_greedy(glm):
    cfg, params = glm
    greedy = _serve(cfg, params, _stream(cfg, 5, 2))[1]
    assert _serve(cfg, params, _stream(cfg, 5, 2), temperature=1e-3,
                  sample_seed=3)[1] == greedy


def test_launch_serve_sampled_cli_on_cpu(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--requests", "3",
                                "--capacity", "2", "--new-tokens", "6",
                                "--max-len", "32", "--device", "cpu",
                                "--temperature", "0.7", "--top-k", "50",
                                "--top-p", "0.9", "--sample-seed", "1"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 6 for r in report.requests)
    assert "temperature=0.7" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# sampled speculative decoding (JAX's test_spec_decode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_world(glm):
    cfg, params = glm
    cfg = dataclasses.replace(cfg, early_exit=None)
    return cfg, params, _serve(cfg, params, _stream(cfg, 7, 0),
                               capacity=3)[1]


def _draft(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-draft1l",
                               num_layers=1)


def test_sampled_tied_acceptance_is_one(spec_world):
    cfg, params, _ = spec_world
    report, _ = _serve(cfg, params, _stream(cfg, 5, 8), chunk=2,
                       temperature=0.9, top_k=16, sample_seed=11,
                       spec=SpecConfig(draft_arch=cfg, k=3,
                                       share_params=True))
    assert report.stats["spec_acceptance"] == 1.0, report.stats
    assert report.stats["spec_proposed"] > 0


def test_sampled_spec_deterministic_per_seed(spec_world):
    cfg, params, _ = spec_world

    def run():
        return _serve(cfg, params, _stream(cfg, 5, 8), chunk=2,
                      temperature=0.8, top_k=12, sample_seed=7,
                      spec=SpecConfig(draft_arch=_draft(cfg), k=2))[1]

    assert run() == run()


def test_sampled_spec_placement_independent(spec_world):
    """Seeded requests through engines of capacity 2 and 4 (other slots,
    admission order and co-batched requests) emit the same tokens."""
    cfg, params, _ = spec_world
    out = [_serve(cfg, params, _stream(cfg, 6, 9, seeds=True), chunk=2,
                  capacity=cap, temperature=0.9, top_k=8,
                  spec=SpecConfig(draft_arch=_draft(cfg), k=3))[1]
           for cap in (2, 4)]
    assert out[0] == out[1]


def test_sampled_spec_low_temperature_collapses_to_greedy(spec_world):
    """A distribution-preserving rejection rule emits the greedy tokens as
    the temperature goes to 0, even with a disagreeing draft."""
    cfg, params, greedy = spec_world
    _, got = _serve(cfg, params, _stream(cfg, 7, 0), capacity=3, chunk=2,
                    temperature=0.001, sample_seed=3,
                    spec=SpecConfig(draft_arch=_draft(cfg), k=3))
    assert got == greedy


def test_sampled_spec_distribution_matches_plain_sampling(spec_world):
    """240 seeded two-token requests on one prompt through the plain and
    the speculative sampled engines (top-k 2, a disagreeing draft): the
    second-token marginals agree within a total variation of 0.12."""
    cfg, params, _ = spec_world
    prompt = (np.arange(6, dtype=np.int32) * 11 + 5) % cfg.vocab_size
    counts = {}
    for tag, spec in (("plain", None),
                      ("spec", SpecConfig(draft_arch=_draft(cfg), k=2))):
        rng = np.random.default_rng(123)
        reqs = [Request(rid=i, prompt=prompt.copy(), max_new_tokens=2,
                        seed=int(rng.integers(0, 2**31)))
                for i in range(240)]
        _, toks = _serve(cfg, params, reqs, capacity=8, max_len=16, chunk=2,
                         temperature=1.0, top_k=2, spec=spec)
        pairs = [tuple(t[:2]) for t in toks.values()]
        counts[tag] = {p: pairs.count(p) / len(pairs) for p in set(pairs)}
    support = set(counts["plain"]) | set(counts["spec"])
    tv = 0.5 * sum(abs(counts["plain"].get(s, 0.0)
                       - counts["spec"].get(s, 0.0)) for s in support)
    assert tv < 0.12, (tv, counts)


# ---------------------------------------------------------------------------
# the acceptance rule alone
# ---------------------------------------------------------------------------


def _simplex(rng, shape):
    p = rng.random(shape) ** 3
    p[..., 0] = 0.0                              # a token q and p never draw
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def test_spec_accept_matches_its_closed_form():
    rng = np.random.default_rng(5)
    s, k, v = 64, 3, 6
    p, q = _simplex(rng, (s, k + 1, v)), _simplex(rng, (s, k, v))
    p[0] = np.concatenate([q[0], p[0, k:]])      # row 0: residual mass 0
    drafts = rng.integers(1, v, (s, k)).astype(np.int32)
    u = rng.random((s, k)).astype(np.float32)
    noise = rng.gumbel(size=(s, k + 1, v)).astype(np.float32)
    acc, emit = spec_accept(*(torch.from_numpy(a) for a in
                              (p, q, drafts, u, noise)))
    pd = np.take_along_axis(p[:, :k], drafts[..., None], 2)[..., 0]
    qd = np.take_along_axis(q, drafts[..., None], 2)[..., 0]
    want_acc = u * qd < pd
    resid = np.clip(p[:, :k] - q, 0.0, None)
    resid = np.where(resid.sum(-1, keepdims=True) > 1e-9, resid, p[:, :k])
    with np.errstate(divide="ignore"):
        corr = (np.log(resid) + noise[:, :k]).argmax(-1)
        bonus = (np.log(p[:, k]) + noise[:, k]).argmax(-1)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_array_equal(emit[:, :k].numpy(),
                                  np.where(want_acc, drafts, corr))
    np.testing.assert_array_equal(emit[:, k].numpy(), bonus)
    assert emit.dtype == torch.int32 and acc.dtype == torch.bool
    # a zero-mass residual draws from p itself: never a token p cannot draw
    assert (p[0, :k][np.arange(k), emit[0, :k].numpy()] > 0).all()


def test_spec_accept_emits_the_target_distribution():
    """Draft d ~ q, accepted with probability min(1, p(d) / q(d)), else a
    draw from the normalised residual: the first emitted token is
    distributed as p (closed form), within Monte Carlo noise of 40000
    draws from a fixed seed."""
    gen = torch.Generator().manual_seed(0)
    n, v = 40000, 5
    p = torch.tensor([0.5, 0.2, 0.15, 0.1, 0.05])
    q = torch.tensor([0.1, 0.3, 0.3, 0.2, 0.1])
    drafts = torch.multinomial(q, n, replacement=True, generator=gen)
    u = torch.rand(n, 1, generator=gen)
    noise = -torch.log(-torch.log(torch.rand(n, 2, v, generator=gen)))
    acc, emit = spec_accept(p.expand(n, 2, v), q.expand(n, 1, v),
                            drafts[:, None].int(), u, noise)
    freq = torch.bincount(emit[:, 0].long(), minlength=v).float() / n
    assert 0.5 * (freq - p).abs().sum() < 0.01, freq
    rate = acc.float().mean()
    assert abs(rate - torch.minimum(p, q).sum()) < 0.01, rate

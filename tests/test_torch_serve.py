"""The port's serving path against its own reference loop and against the
JAX package's engine.

Greedy tokens of the port's ``SlotEngine`` + ``serve()`` must equal the
port's ``generate`` on each prompt and the JAX ``SlotEngine`` + ``serve()``
tokens, with more requests than slots so that finished slots are
backfilled. ``yi-9b.reduced(dtype="float32")``, weights from the JAX
``init_lm`` through ``params_from_jax``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.scheduler import poisson_requests as jax_requests
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import SlotEngine, generate
from repro_torch.serve.scheduler import Request, poisson_requests, serve


def _setup(threshold):
    jcfg = get_arch("yi-9b").reduced(dtype="float32")
    pcfg = port_arch("yi-9b").reduced(dtype="float32")
    jcfg = dataclasses.replace(jcfg, early_exit=dataclasses.replace(
        jcfg.early_exit, entropy_threshold=threshold))
    pcfg = dataclasses.replace(pcfg, early_exit=dataclasses.replace(
        pcfg.early_exit, entropy_threshold=threshold))
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("threshold", [0.45, 1.0])
def test_serve_matches_generate_and_jax_engine(threshold):
    jcfg, pcfg, jp, pp = _setup(threshold)
    kw = dict(num=5, rate_hz=np.inf, prompt_lens=(3, 12), max_new_tokens=6,
              vocab_size=256, seed=0)
    preqs, jreqs = poisson_requests(**kw), jax_requests(**kw)
    for a, b in zip(preqs, jreqs):            # the same stream in both
        np.testing.assert_array_equal(a.prompt, b.prompt)
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=4, device="cpu")
    report = serve(engine, pp, preqs)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=AccelConfig())
    jax_serve(JaxSlotEngine(run, capacity=2, max_len=32, chunk=4), jp, jreqs)
    assert report.completion_rate == 1.0
    assert report.stats["max_concurrency"] == 2.0      # backfill happened
    for pr, jr in zip(preqs, jreqs):
        solo, _ = generate(pcfg, pp, pr.prompt[None], 6, device="cpu")
        assert pr.tokens == solo[0].tolist(), pr.rid
        assert pr.tokens == jr.tokens, pr.rid
    want = 1.0 if threshold == 1.0 else 0.0
    assert report.stats["exit_rate"] == pytest.approx(want)


def test_too_long_request_is_rejected_not_truncated():
    _, pcfg, _, pp = _setup(0.45)
    reqs = [Request(0, np.arange(30, dtype=np.int32), 8),
            Request(1, np.arange(4, dtype=np.int32), 3)]
    report = serve(SlotEngine(pcfg, capacity=1, max_len=32, device="cpu"),
                   pp, reqs)
    assert reqs[0].reject_reason.startswith("too-long")
    assert reqs[0].tokens == [] and len(reqs[1].tokens) == 3
    assert report.completion_rate == 0.5


def test_nan_logits_quarantine_only_that_slot():
    """A slot whose logits go non-finite is shed; its co-batched request
    is untouched and the slot's KV row is scrubbed for the next occupant."""
    _, pcfg, _, pp = _setup(0.45)
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=4, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 6).astype(np.int32) for _ in range(2)]
    reqs = [Request(i, p, 6) for i, p in enumerate(prompts)]
    from repro_torch.serve.scheduler import SlotScheduler
    sched = SlotScheduler(engine, pp)
    for r in reqs:
        sched.admit(r, 0.0)
    with torch.inference_mode():                     # poison slot 1's KV
        sched.cache.v[:, 1, :, :3] = float("nan")
    while sched.busy:
        sched.step_chunk(0.0)
    solo, _ = generate(pcfg, pp, prompts[0][None], 6, device="cpu")
    assert reqs[0].reject_reason is None and reqs[0].tokens == solo[0].tolist()
    assert reqs[1].reject_reason.startswith("nan-quarantined")
    assert torch.isfinite(sched.cache.v[:, 1]).all()


def test_launch_serve_cli_on_cpu(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--requests", "3",
                                "--capacity", "2", "--new-tokens", "4",
                                "--max-len", "32", "--device", "cpu"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 4 for r in report.requests)
    assert "tok/s" in capsys.readouterr().out

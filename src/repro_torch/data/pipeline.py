"""Deterministic synthetic data (port of ``repro.data.pipeline``).

``lm_batches``: token streams for the LMs, deterministic in (seed, step,
host), so a resumed run continues mid-stream bit for bit and every host
of a multi-host job slices its own shard. ``Prefetcher`` makes them ahead
on a daemon thread.

The paper's seizure-detection data (``bio_signal_batches``): highly
unbalanced windows of multichannel pseudo-EEG. Positive windows superpose
a 3-12 Hz oscillatory burst (a seizure signature) on 1/f-ish background
noise, so the task is learnable but not trivial, which is what makes the
early-exit entropy threshold meaningful.

numpy only, and the same draws in the same order as the JAX package's
generators: a batch depends on its seed and step (and host) alone and its
arrays equal the JAX package's bit for bit. :func:`bio_signal_steps`
makes many batches at once on a thread pool (numpy's ufuncs release the
GIL); each is the generator's batch of that step.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator

import numpy as np


def lm_batches(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
               start_step: int = 0, host_id: int = 0, num_hosts: int = 1
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Markov-ish synthetic token stream: a per-step random source mixed
    with a shifted copy, so next-token prediction has learnable structure.
    ``inputs`` and ``labels`` int32 [batch / num_hosts, seq_len], the
    labels the inputs shifted by one."""
    local_batch = batch // num_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id]))
        base = rng.integers(0, vocab_size, (local_batch, seq_len + 1),
                            dtype=np.int32)
        # structure: 70% of positions copy the previous token +1 (mod V)
        copy_mask = rng.random((local_batch, seq_len + 1)) < 0.7
        shifted = (np.roll(base, 1, axis=1) + 1) % vocab_size
        tokens = np.where(copy_mask, shifted, base).astype(np.int32)
        yield {"inputs": tokens[:, :-1], "labels": tokens[:, 1:],
               "step": step}
        step += 1


class Prefetcher:
    """Run a generator in a daemon thread, keep ``depth`` batches ready."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def bio_signal_batch(batch: int, window: int = 1024, channels: int = 18,
                     positive_rate: float = 0.15, seed: int = 0,
                     step: int = 0) -> Dict[str, np.ndarray]:
    """One batch of unbalanced synthetic EEG windows: ``inputs`` float32
    [batch, window, channels], ``labels`` int32 [batch] (1 = seizure)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    t = np.arange(window, dtype=np.float32)
    # 1/f-ish background: sum of damped random sinusoids
    x = np.zeros((batch, window, channels), np.float32)
    for _ in range(4):
        f = rng.uniform(0.5, 40.0, (batch, 1, channels))
        ph = rng.uniform(0, 2 * np.pi, (batch, 1, channels))
        amp = rng.uniform(0.2, 1.0, (batch, 1, channels)) / np.sqrt(f)
        x += amp * np.sin(2 * np.pi * f * t[None, :, None] / 256.0 + ph)
    x += 0.3 * rng.standard_normal((batch, window, channels)).astype(
        np.float32)
    labels = (rng.random(batch) < positive_rate).astype(np.int32)
    # seizure signature: rhythmic 3-12 Hz burst over a sub-window,
    # spatially correlated across a random subset of channels
    for i in np.nonzero(labels)[0]:
        f = rng.uniform(3.0, 12.0)
        start = rng.integers(0, window // 2)
        dur = rng.integers(window // 4, window // 2)
        sl = slice(start, min(start + dur, window))
        ch_mask = rng.random(channels) < 0.6
        burst = 2.0 * np.sin(2 * np.pi * f * t[sl] / 256.0
                             + rng.uniform(0, 2 * np.pi))
        x[i, sl, :] += burst[:, None] * ch_mask[None, :]
    return {"inputs": x, "labels": labels, "step": step}


def bio_signal_batches(batch: int, window: int = 1024, channels: int = 18,
                       positive_rate: float = 0.15, seed: int = 0,
                       start_step: int = 0
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Unbalanced synthetic EEG windows, one batch a step from
    ``start_step`` on. label 1 = seizure."""
    step = start_step
    while True:
        yield bio_signal_batch(batch, window, channels, positive_rate, seed,
                               step)
        step += 1


def bio_signal_steps(steps: Iterable[int], batch: int, window: int = 1024,
                     channels: int = 18, positive_rate: float = 0.15,
                     seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """The batches of :func:`bio_signal_batches` at ``steps``, in order,
    made ahead by one thread a CPU core (at most 8), with at most two a
    thread in flight."""
    workers = min(8, os.cpu_count() or 1)
    steps = iter(steps)
    with ThreadPoolExecutor(workers) as pool:
        pending = deque(
            pool.submit(bio_signal_batch, batch, window, channels,
                        positive_rate, seed, s)
            for s in itertools.islice(steps, 2 * workers))
        while pending:
            out = pending.popleft().result()
            for s in itertools.islice(steps, 1):
                pending.append(pool.submit(bio_signal_batch, batch, window,
                                           channels, positive_rate, seed, s))
            yield out

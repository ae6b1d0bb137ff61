"""Deterministic synthetic LM data pipeline, host-sharded and prefetching
(port of ``repro.data.pipeline``, numpy only: ``make_batch`` is the
reference's, bit for bit).

Determinism-by-step is the fault-tolerance primitive: batch(step) is a pure
function of (seed, step, host slice), so any host can recompute any batch —
resume after preemption replays the exact stream, and straggler work-stealing
needs no data-state handoff.

The generator produces Zipf-ish token streams with short-range structure
(repeated n-grams) so that tiny-model training loss visibly decreases.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_repeat: int = 8          # structure: periodic n-gram echo


def _host_slice(global_batch: int, process_index: int, process_count: int):
    per = global_batch // process_count
    return process_index * per, per


def make_batch(dc: DataConfig, step: int, process_index: int = 0,
               process_count: int = 1) -> dict:
    """Pure function of (config, step, host): {'tokens','labels'} numpy."""
    start, per = _host_slice(dc.global_batch, process_index, process_count)
    rng = np.random.default_rng(
        np.random.SeedSequence([dc.seed, step, start]))
    # Zipf marginal clipped to vocab
    base = rng.zipf(dc.zipf_a, size=(per, dc.seq_len + 1)) % dc.vocab_size
    # inject learnable short-range structure: echo of lag `ngram_repeat`
    lag = dc.ngram_repeat
    echo_mask = rng.random((per, dc.seq_len + 1)) < 0.5
    base[:, lag:] = np.where(echo_mask[:, lag:], base[:, :-lag], base[:, lag:])
    tokens = base[:, :-1].astype(np.int32)
    labels = base[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


class Prefetcher:
    """Background-thread prefetch of the deterministic stream."""

    def __init__(self, dc: DataConfig, start_step: int = 0, depth: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dc = dc
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._pi, self._pc = process_index, process_count
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.dc, step, self._pi, self._pc)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            yield self.q.get()

    def stop(self):
        self._stop.set()


def data_config_for(cfg: ModelConfig, seq_len: int, global_batch: int,
                    seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)

"""Deterministic synthetic token pipeline, the JAX package's
``data/pipeline.py``.

Batches are a pure function of (seed, step), drawn with numpy exactly as
the reference draws them, so the two packages see the same bytes; after a
restart the pipeline replays exactly, which is what makes a resume from a
checkpoint continue bit for bit.  A background thread keeps
``prefetch_depth`` batches ready; they are numpy on the host, and
``Pipeline`` puts each on its device as it hands it out.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec

# the Whisper encoder's frames per clip (the reference's
# models/whisper.py: ENC_LEN), so that enc-dec batches draw the same bytes
ENC_LEN = 1500


@dataclass
class DataConfig:
    seed: int = 1234
    prefetch_depth: int = 2


def make_batch_np(cfg: ArchConfig, shape: ShapeSpec, seed: int,
                  step: int) -> dict:
    """Pure (seed, step) -> batch of numpy arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal(
            (b, ENC_LEN, cfg.d_model), dtype=np.float32)
        tok = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
        out["tokens"], out["labels"] = tok[:, :-1], tok[:, 1:]
    elif cfg.frontend == "vision":
        out["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)
        out["labels"] = rng.integers(0, cfg.vocab_size, (b, s),
                                     dtype=np.int32)
    else:
        tok = rng.integers(0, cfg.vocab_size, (b, s + 1), dtype=np.int32)
        out["tokens"], out["labels"] = tok[:, :-1], tok[:, 1:]
    return out


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (contiguous copies)."""
    return {k: torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for k, x in batch.items()}


class Pipeline:
    """Prefetching iterator starting at ``start_step`` (for resume); each
    batch comes out as tensors on ``device``."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig(), start_step: int = 0,
                 device="cpu"):
        self.cfg, self.shape, self.dc = cfg, shape, data_cfg
        self.step = start_step
        self.device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=data_cfg.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch_np(self.cfg, self.shape, self.dc.seed, step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        while True:
            step, batch = self._q.get()
            if step == self.step:      # drop stale prefetches after resume
                break
        self.step += 1
        return to_device(batch, self.device)

    def close(self):
        self._stop.set()
        self._thread.join()

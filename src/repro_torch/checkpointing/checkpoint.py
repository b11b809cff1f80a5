"""Checkpointing: save and restore a train state, with async writes; the
JAX package's ``checkpointing/checkpoint.py``, in its file format.

A checkpoint is a flat ``.npz`` file keyed by the reference's tree paths
(``params/groups/0/tm/mu_x``, each group's layers stacked on axis 0;
``opt/m/...``, ``opt/v/...``, ``step``) plus a JSON manifest, so a
checkpoint written by either package resumes in the other
(``repro_torch.convert.train_state_arrays`` and ``load_train_state``
carry the port's state across, one leaf at a time).  Writes go to a temp file and an atomic
rename; ``AsyncSaver`` overlaps the write with the next step.
``latest_step`` with the replayable data pipeline gives a restart that
continues bit for bit (tests/test_torch_checkpoint.py).
"""
from __future__ import annotations

import json
import os
import threading
import time
import zipfile

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import load_train_state, train_state_arrays


def _write(path: str, step: int, items) -> str:
    """Write (key, array) pairs as ``step-XXXXXXXX.npz``, one at a time,
    in ``numpy.savez``'s format (stored zip members "key.npy"), and point
    the manifest at it."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp-{step}.npz")
    final = os.path.join(path, f"step-{step:08d}.npz")
    n = 0
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asarray(arr),
                                          allow_pickle=False)
            n += 1
    os.replace(tmp, final)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"latest_step": step, "time": time.time(),
                   "n_arrays": n}, f)
    return final


def save(path: str, step: int, state: dict, cfg: ArchConfig) -> str:
    """Save a port train state at ``step``, leaf by leaf."""
    return _write(path, step, train_state_arrays(state, cfg))


class AsyncSaver:
    """Overlaps checkpoint writes with compute (one in flight): the state
    is copied to the host before ``save_async`` returns (the train step
    updates it in place), and written by a thread."""

    def __init__(self):
        self._thread = None

    def save_async(self, path: str, step: int, state: dict,
                   cfg: ArchConfig):
        self.wait()
        items = list(train_state_arrays(state, cfg))      # sync copy
        self._thread = threading.Thread(
            target=_write, args=(path, step, items), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(path: str) -> int | None:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["latest_step"]


def restore(path: str, step: int, state: dict, cfg: ArchConfig) -> dict:
    """Fill the port train state ``state`` from the checkpoint at
    ``step``, written by either package, in place, reading one array at a
    time; returns it."""
    with np.load(os.path.join(path, f"step-{step:08d}.npz")) as data:
        return load_train_state(data, state, cfg)

"""Device meshes: the simulator core's 1-D mesh, and the training meshes
with ('data', 'model') or ('pod', 'data', 'model') axes; the port's
``repro.launch.mesh``.

A mesh is held by this one process (core/distribute.py:Mesh); building
one touches no device.  Its positions are the first CUDA cards, one named
device at every position (``device="cpu"``, or ``device="cuda:0"``: one
card repeated), or an explicit ``devices`` list, which may repeat one
card.  The 2-D ('cfg', 'sm') sweep meshes are built by
``repro_torch.core.distribute.make_mesh``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.distribute import Mesh, mesh_devices
from repro_torch.parallelism.ctx import ShardCtx

TRAIN_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def make_host_mesh(n: int | None = None, axis: str = "sm", device=None,
                   devices=None) -> Mesh:
    """1-D mesh of ``n`` positions named ``axis``: the first ``n`` CUDA
    cards (all of them when ``n`` is None), the CPU at every position
    with ``device="cpu"``, or the explicit ``devices`` list, which may
    repeat one card."""
    devs = mesh_devices(n, device=device, devices=devices,
                        what=f"mesh ({n},)")
    return Mesh(devs, (axis,))


def make_train_mesh(shape: tuple, *, device=None, devices=None) -> Mesh:
    """A training mesh of ``shape``: axes ('data', 'model') for two
    dimensions, ('pod', 'data', 'model') for three; positions row-major."""
    shape = tuple(shape)
    if len(shape) not in TRAIN_AXES:
        raise ValueError(f"a training mesh has 2 or 3 axes, got {shape}")
    devs = mesh_devices(int(np.prod(shape)), device=device, devices=devices,
                        what=f"mesh {shape}")
    return Mesh(np.asarray(devs, dtype=object).reshape(shape),
                TRAIN_AXES[len(shape)])


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) over ('data', 'model'),
    or (2, 16, 16) over ('pod', 'data', 'model') with ``multi_pod``, on the
    first 256 or 512 CUDA cards, or on ``devices`` (which may repeat one
    card) or one named ``device``; too few cards raise, naming
    ``devices=``."""
    return make_train_mesh((2, 16, 16) if multi_pod else (16, 16),
                           device=device, devices=devices)


def make_ctx(mesh) -> ShardCtx:
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    tp = "model" if "model" in mesh.axis_names else None
    return ShardCtx(mesh=mesh, batch_axes=batch_axes, tp_axis=tp)

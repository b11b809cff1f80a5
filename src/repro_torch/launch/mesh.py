"""The simulator core's 1-D device mesh.

The port's ``repro.launch.mesh.make_host_mesh``.  A mesh is held by this
one process (core/distribute.py:Mesh); building one touches no device.
The 2-D ('cfg', 'sm') sweep meshes are built by
``repro_torch.core.distribute.make_mesh``.
"""
from __future__ import annotations

from repro_torch.core.distribute import Mesh, mesh_devices


def make_host_mesh(n: int | None = None, axis: str = "sm", device=None,
                   devices=None) -> Mesh:
    """1-D mesh of ``n`` positions named ``axis``: the first ``n`` CUDA
    cards (all of them when ``n`` is None), the CPU at every position
    with ``device="cpu"``, or the explicit ``devices`` list, which may
    repeat one card."""
    devs = mesh_devices(n, device=device, devices=devices,
                        what=f"mesh ({n},)")
    return Mesh(devs, (axis,))

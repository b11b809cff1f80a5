"""2-D ('cfg', 'sm') mesh distribution — sweeps across devices.

The port's ``repro.core.distribute``.  One mesh shape serves every
distribution shape:

  · the lane axis of ``sweep()`` / ``grid_sweep()`` is split over the
    mesh's **'cfg'** axis — config lanes are independent, so this needs
    no communication;
  · within each lane, the SM axis is split over the **'sm'** axis with the
    per-group quantum step of the 1-D shard mode
    (core/parallel.py:make_shard_body): the serial region runs on the
    request and warp tables gathered from the group's blocks, which keeps
    sequential semantics bit-exactly.

Every lane is bit-identical to its solo single-device run at any mesh
shape — 1×N, N×1, A×B.  All simulator state is int32, so there is no
floating-point reassociation to worry about.

The mesh is **single-controller**, as the reference's is: one Python
process holds a ``Mesh``, an ``(n_cfg, n_sm)`` object array of
``torch.device`` with axis names ('cfg', 'sm'), and issues every copy and
sum between its positions (the reference's all-gather and ``psum`` over
'sm').  ``sweep()``, ``grid_sweep()``, ``dse --search`` and the launchers
stay in-process APIs that return their results to the caller.  A
position may repeat a device: ``devices=`` repeating one card,
``device="cuda:0"`` (that card at every position) or ``device="cpu"``
(the CPU at every position) — the counterpart of the reference's forced
host devices.  Each 'cfg' group's serial region runs
on the group's first device (core/parallel.py).

CPU recipe:

    python -m repro_torch.launch.zoo --grid 4 4 --mesh 2 2 --check \\
        --device cpu
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import run_groups_stacked
from repro_torch.core.parallel import (SHARDED_PARTS, block_device, dyn_to,
                                       gather_sm, make_sharded_quantum,
                                       reset_group, run_kernel_groups,
                                       select_group, split_sm, tree_to)
from repro_torch.sim.config import DynConfig, StaticConfig, static_part

CFG_AXIS, SM_AXIS = "cfg", "sm"

# state parts with a leading n_sm axis (split over 'sm'); the rest —
# mem/ctrl/stats — stay whole on an 'sm' group's first device
STATE_PARTS = ("warp", "sm", "req", "mem", "ctrl", "stats_sm", "stats")


class Mesh:
    """A device mesh held by this one process: ``devices``, an object
    array of ``torch.device`` with one axis per name in ``axis_names``;
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [torch.device(d) for d in arr.flat]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {self.devices.shape} "
                             f"do not match the axes {self.axis_names}")
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"mesh devices must share one device type, "
                             f"got {sorted(kinds)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def describe(self) -> dict:
        """JSON-safe summary: axes, shape and the device at each position
        in row-major order."""
        return {"axis_names": list(self.axis_names),
                "shape": list(self.devices.shape),
                "devices": [str(d) for d in self.devices.flat]}


def mesh_devices(n, *, device=None, devices=None, what="mesh") -> list:
    """The devices of a mesh of ``n`` positions: ``devices`` as given; one
    named device at every position for ``device="cpu"`` or a CUDA device
    with an index (``"cuda:0"``: one card, repeated); else (``device``
    None or ``"cuda"``) the first ``n`` CUDA cards (``n`` None: every
    card)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
        if n is not None and len(devs) != n:
            raise ValueError(f"{what} needs {n} devices, got {len(devs)} "
                             "in devices=")
        return devs
    if device is not None:
        one = torch.device(device)
        if one.type == "cpu" or (one.type == "cuda" and one.index is not None):
            return [one] * (n or 1)
        if one.type != "cuda":
            raise ValueError(f"no mesh of {one.type} devices: pass "
                             "device=\"cpu\", a CUDA device or devices=")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n is None else n
    if have < n:
        raise RuntimeError(
            f"{what} needs {n} devices, have {have} CUDA devices — pass "
            f"devices= to repeat a card (e.g. devices=[torch.device("
            f"'cuda:0')] * {n}, or device=\"cuda:0\"), or device=\"cpu\" "
            "to put the CPU at every position.")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_cfg: int, n_sm: int = 1, *, device=None,
              devices=None) -> Mesh:
    """2-D ('cfg', 'sm') device mesh over the first n_cfg × n_sm CUDA
    cards; ``device="cpu"`` puts the CPU at every position (and
    ``device="cuda:0"`` that card), and ``devices=`` gives the
    n_cfg · n_sm positions row-major (a card may repeat).

    Either axis may be 1 (1×N = pure SM sharding, N×1 = pure lane
    sharding), so one mesh type serves every distribution shape."""
    devs = mesh_devices(n_cfg * n_sm, device=device, devices=devices,
                        what=f"mesh ({n_cfg}, {n_sm})")
    return Mesh(np.asarray(devs, dtype=object).reshape(n_cfg, n_sm),
                (CFG_AXIS, SM_AXIS))


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """Where a mesh run's results land: the mesh's first device.  A
    ``device`` the caller also gave must be of the mesh's type."""
    home = mesh.devices.flat[0]
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(f"device={str(device)!r} conflicts with a mesh of "
                         f"{home.type} devices: the mesh's devices win, "
                         "drop device= or build the mesh on it")
    return home


def state_specs(*prefix, telem: bool = False) -> dict:
    """Per state part, the mesh axis (or None) that splits each of its
    leading axes — the reference's PartitionSpec prefixes: ``prefix``
    names the lane axes; per-SM parts add the SM axis over 'sm'; mem/ctrl/
    stats (and ``telem``, the counter timeline present when the
    StaticConfig enables telemetry) are not split within an 'sm' group."""
    parts = STATE_PARTS + (("telem",) if telem else ())
    return {k: (*prefix, SM_AXIS) if k in SHARDED_PARTS else tuple(prefix)
            for k in parts}


def check_mesh(mesh: Mesh, scfg: StaticConfig, n_lanes: int) -> None:
    if set(mesh.axis_names) != {CFG_AXIS, SM_AXIS}:
        raise ValueError(
            f"sweep mesh must have axes ('{CFG_AXIS}', '{SM_AXIS}'), got "
            f"{mesh.axis_names} (build one with core.distribute.make_mesh)")
    if n_lanes % mesh.shape[CFG_AXIS]:
        raise ValueError(
            f"{n_lanes} config lanes not divisible by mesh '{CFG_AXIS}' "
            f"axis size {mesh.shape[CFG_AXIS]}")
    if scfg.n_sm % mesh.shape[SM_AXIS]:
        raise ValueError(
            f"n_sm={scfg.n_sm} not divisible by mesh '{SM_AXIS}' axis "
            f"size {mesh.shape[SM_AXIS]}")


def _groups(mesh: Mesh) -> list:
    """Each 'cfg' group's devices along 'sm', in position order."""
    devs = mesh.devices
    if mesh.axis_names.index(CFG_AXIS) != 0:
        devs = devs.T
    return [list(row) for row in devs]


def _cfg_block(x, axis: int, g: int, n_groups: int):
    n = x.shape[axis] // n_groups
    return x.narrow(axis, g * n, n)


def place_lanes(tree, mesh: Mesh, spec=(CFG_AXIS,)) -> list:
    """A lane-stacked tree (a flat dict of tensors or a DynConfig) as one
    tree per 'cfg' group, on the group's first device: the axis that
    ``spec`` names ``CFG_AXIS`` split into the groups' blocks, or the
    whole tree for every group when ``spec`` names no axis."""
    groups = _groups(mesh)
    axis = spec.index(CFG_AXIS) if CFG_AXIS in spec else None

    def block(x, g):
        return x if axis is None else _cfg_block(x, axis, g, len(groups))

    if isinstance(tree, DynConfig):
        return [dyn_to(DynConfig.from_flat(
                    {k: block(v, g) for k, v in tree.flat().items()},
                    tree.icnt.icnt_lat.device), devs[0])
                for g, devs in enumerate(groups)]
    return [tree_to({k: block(v, g) for k, v in tree.items()}, devs[0])
            for g, devs in enumerate(groups)]


def place_state(state: dict, mesh: Mesh, *prefix) -> list:
    """A host-built batched initial state as one group state per 'cfg'
    group (core/parallel.py): leaves lead with the ``prefix`` lane axes,
    the one named ``CFG_AXIS`` split into the groups' blocks and the
    prefix then flattened into the group's one lane axis (a grid's
    ``(None, CFG_AXIS)``: workload-major); per-SM parts split over 'sm'
    (``state_specs``), each block on its position's device; the rest on
    the group's first device."""
    specs = state_specs(*prefix, telem="telem" in state)
    groups = _groups(mesh)
    axis = prefix.index(CFG_AXIS)

    def lanes(part, g):
        return {k: (lambda b: b.reshape(-1, *b.shape[len(prefix):]))(
                    _cfg_block(v, axis, g, len(groups)))
                for k, v in part.items()}

    return [{k: split_sm(lanes(v, g), devs) if SM_AXIS in specs[k]
             else tree_to(lanes(v, g), devs[0])
             for k, v in state.items()}
            for g, devs in enumerate(groups)]


def gather_state(groups: list, shape: tuple, device) -> dict:
    """The inverse of ``place_state``: the group states reassembled into
    the caller's whole state on ``device``, with lane axes ``shape``
    ((L,) for a sweep, (W, C) for a grid; the last is the one split over
    'cfg')."""
    axis = len(shape) - 1
    lead = (*shape[:-1], shape[-1] // len(groups))

    def whole(st):
        return {k: gather_sm(v, device) if isinstance(v, list)
                else tree_to(v, device) for k, v in st.items()}

    parts = [whole(st) for st in groups]
    return {k: {f: torch.cat([p[k][f].reshape(*lead, *p[k][f].shape[1:])
                              for p in parts], axis)
                for f in parts[0][k]}
            for k in parts[0]}


def make_dist_kernel_runner(scfg: StaticConfig, n_sm_dev: int,
                            exchange: str = "window",
                            max_cycles: int = 1 << 20,
                            early_exit: bool = True):
    """The sharded analogue of ``engine.run_kernel`` for every 'cfg' group
    at once, pluggable into ``engine.run_groups_stacked``:
    ``runner(states, packeds, dyns) -> states``, where ``states[g]`` is
    group ``g``'s state (per-SM parts as blocks), ``packeds[g]`` its
    lanes' packed kernel on its first device and ``dyns[g]`` its
    DynConfig, one copy per block.  The groups step in lockstep
    (core/parallel.py:run_kernel_groups); the counter timeline's sums add
    over each group's blocks."""
    step = make_sharded_quantum(scfg, n_sm_dev, exchange)

    def runner(states, packeds, dyns):
        traces = [[tree_to(p, block_device(w)) for w in st["warp"]]
                  for st, p in zip(states, packeds)]
        return run_kernel_groups(states, traces, dyns, step, scfg,
                                 max_cycles, early_exit)

    return runner


def _make_lane_runner(scfg: StaticConfig, n_sm_dev: int, exchange: str,
                      max_cycles: int, early_exit: bool = True):
    """Whole workloads in every 'cfg' group's lanes, each group on its SM
    blocks: ``run(states, stackeds, dyns) -> states``.  The kernel loop,
    reset, masking and timeout accounting are the engine's
    (``run_groups_stacked``); the reset takes a local-shape StaticConfig
    (one block's SMs), the serial region keeps the full one."""
    local = dataclasses.replace(scfg, n_sm=scfg.n_sm // n_sm_dev)
    kernel_runner = make_dist_kernel_runner(scfg, n_sm_dev, exchange,
                                            max_cycles, early_exit)

    def run_lanes(states, stackeds, dyns):
        blocks = [[dyn_to(d, block_device(w)) for w in st["warp"]]
                  for st, d in zip(states, dyns)]
        return run_groups_stacked(states, stackeds, local, blocks,
                                  kernel_runner, reset=reset_group,
                                  select=select_group)

    return run_lanes


def make_dist_sweep_runner(scfg: StaticConfig, mesh: Mesh,
                           max_cycles: int = 1 << 20,
                           exchange: str = "window",
                           early_exit: bool = True):
    """A config sweep on a ('cfg', 'sm') mesh: ``(state_groups,
    stacked_groups, dyn_groups) -> final state`` — the arguments placed by
    ``place_state(…, CFG_AXIS)``, ``place_lanes(stacked, mesh, ())`` and
    ``place_lanes(dyn)``; the result is the whole ``(L, …)`` state on the
    mesh's first device.  Lanes are split over 'cfg', each lane's SM axis
    over 'sm'."""
    from repro_torch.core.sweep import _lanes

    scfg = static_part(scfg)
    run_lanes = _make_lane_runner(scfg, mesh.shape[SM_AXIS], exchange,
                                  max_cycles, early_exit)

    def run(states, stackeds, dyns):
        lanes = [_lanes(s, d.icnt.icnt_lat.shape[0])
                 for s, d in zip(stackeds, dyns)]
        out = run_lanes(states, lanes, dyns)
        n = sum(d.icnt.icnt_lat.shape[0] for d in dyns)
        return gather_state(out, (n,), mesh.devices.flat[0])

    return run


def make_dist_grid_runner(scfg: StaticConfig, mesh: Mesh,
                          max_cycles: int = 1 << 20,
                          exchange: str = "window",
                          early_exit: bool = True):
    """A whole (workload × config) grid on a ('cfg', 'sm') mesh — the
    distributed twin of ``core/sweep.py:make_grid_runner``:
    ``(state_groups, stacked_groups, dyn_groups) -> final (W, C, …)
    state`` on the mesh's first device.  Every group runs all W workloads
    for its config lanes (W · C/n_cfg lanes, workload-major); the config
    axis is split over 'cfg', the SM axis over 'sm'."""
    from repro_torch.core.sweep import grid_lanes

    scfg = static_part(scfg)
    run_lanes = _make_lane_runner(scfg, mesh.shape[SM_AXIS], exchange,
                                  max_cycles, early_exit)

    def run(states, stackeds, dyns):
        laned = [grid_lanes(s, d) for s, d in zip(stackeds, dyns)]
        out = run_lanes(states, [s for s, _ in laned],
                        [d for _, d in laned])
        n_w = stackeds[0]["n_ctas"].shape[0]
        n_c = sum(d.icnt.icnt_lat.shape[0] for d in dyns)
        return gather_state(out, (n_w, n_c), mesh.devices.flat[0])

    return run

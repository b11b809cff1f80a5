"""Execution modes for the SM phase — the paper's `#pragma omp parallel for`.

  'seq'   — a Python loop over SMs, lane by lane: one SM of one lane at
            a time (single-thread reference)
  'vmap'  — every SM of every lane at once: on the card, one launch of
            the fused ``sm_quantum`` kernel per quantum
  'shard' — the SM axis split over the 'sm' axis of a device mesh
            (core/distribute.py:Mesh): each position simulates its SM
            block; the serial region (memory system + CTA dispatch) runs
            on the full request table gathered from every block, which
            keeps sequential semantics bit-exactly at any device count.

The state carries a leading lane axis ``(L, n_sm, …)`` (core/sweep.py);
a solo simulation is one lane.

The mesh is single-controller, as JAX's is: this one process holds every
block and issues the gathers, each block's SM phase on its own device,
and the sums that stand for the reference's ``psum`` over 'sm'.  The
reference computes the serial region replicated on every device of an
'sm' group; here it runs once per group, on the group's first device,
which then sends each device its slice: the paper's master thread.  Both
give the same numbers.

A **group state** is a state whose per-SM parts (``SHARDED_PARTS``) are
lists of blocks in position order: block ``i`` lives on the group's
``i``-th device and holds SM positions ``[i·chunk, (i+1)·chunk)`` of every
lane, each leaf its own contiguous tensor (``sm_quantum`` takes no other).
``mem``, ``ctrl``, the global stats and ``telem`` stay whole on the
group's first device.

SM→device assignment (the OpenMP scheduler's analogue):
  'static'  — contiguous SM blocks per device
  'dynamic' — a deterministic load-aware deal: SMs dealt round-robin, so
              the early SMs (CTA-heavy under round-robin dispatch) spread
              evenly.
Both relabel the SM axis only: results are identical, and only each
device's share of the work changes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.engine import _select, converged, stamp_done
from repro_torch.core.plan import EXCHANGES
from repro_torch.sim.config import DynConfig, split_config, static_part
from repro_torch.sim.cta import cta_issue
from repro_torch.sim.memsys import mem_phase
from repro_torch.sim.smcore import finish, sm_cycles_eager, sm_quantum
from repro_torch.sim.state import reset_for_kernel

# state parts with an SM axis after the lane axis: split over 'sm'
SHARDED_PARTS = ("warp", "sm", "req", "stats_sm")


def make_sm_runner(cfg, mode: str = "vmap", mesh=None):
    """Returns sm_runner(warp, sm, req, stats_sm, trace, t0, dyn), every
    argument with a leading lane axis.

    mode='shard' needs a ``mesh`` with an 'sm' axis: each call splits the
    per-SM parts over that axis, runs each block's SM phase on its device
    and gathers the blocks back, while the serial region stays on the
    full arrays in ``engine.quantum_step``.  For the fully sharded quantum
    (the serial region on the gathered tables, blocks kept on their
    devices) see ``make_sharded_quantum`` / ``run_kernel_sharded``."""
    scfg = static_part(cfg)

    if mode == "vmap":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            return sm_quantum(warp, sm, req, stats_sm, trace, t0, scfg, dyn)
        return runner

    if mode == "seq":
        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            parts = (warp, sm, req, stats_sm)
            outs = []                   # outs[lane][sm] = (warp, sm, ...)
            for lane in range(t0.shape[0]):
                one = slice(lane, lane + 1)
                tr = {k: v[one] for k, v in trace.items()}
                dl = dyn.map(lambda x: x[one])
                outs.append([sm_quantum(*({k: v[one, i:i + 1]
                                           for k, v in p.items()}
                                          for p in parts), tr, t0[one],
                                        scfg, dl)
                             for i in range(scfg.n_sm)])
            return tuple({k: torch.cat([torch.cat([o[j][k] for o in lane], 1)
                                        for lane in outs])
                          for k in parts[j]} for j in range(len(parts)))
        return runner

    if mode == "shard":
        if mesh is None or "sm" not in mesh.axis_names:
            raise ValueError(
                "mode='shard' needs mesh= with an 'sm' axis, e.g. "
                "make_sm_runner(cfg, 'shard', make_host_mesh(n, 'sm'))")
        devs = sm_devices(mesh)
        if scfg.n_sm % len(devs):
            raise ValueError(
                f"n_sm={scfg.n_sm} not divisible by mesh 'sm' axis "
                f"size {len(devs)}")

        def runner(warp, sm, req, stats_sm, trace, t0, dyn):
            home = t0.device
            blocks = [split_sm(p, devs) for p in (warp, sm, req, stats_sm)]
            outs = [sm_quantum(*(b[i] for b in blocks), tree_to(trace, d),
                               t0.to(d), scfg, dyn_to(dyn, d))
                    for i, d in enumerate(devs)]
            return tuple(gather_sm([o[j] for o in outs], home)
                         for j in range(len(blocks)))
        return runner

    raise ValueError(f"unknown mode {mode!r} (expected seq/vmap/shard)")


# ---------------------------------------------------------------------------
# blocks: splitting and gathering the SM axis
# ---------------------------------------------------------------------------

def sm_devices(mesh) -> list:
    """The devices along the mesh's 'sm' axis (position 0 on any other
    axis), in position order."""
    axis = mesh.axis_names.index("sm")
    devs = mesh.devices[tuple(slice(None) if i == axis else 0
                              for i in range(mesh.devices.ndim))]
    return list(devs)


def block_device(part: dict) -> torch.device:
    return next(iter(part.values())).device


def tree_to(tree: dict, device) -> dict:
    """A flat dict of tensors on ``device`` (no copy where it is there)."""
    return {k: v.to(device) for k, v in tree.items()}


def dyn_to(dyn: DynConfig, device) -> DynConfig:
    """A DynConfig's leaves on ``device``."""
    if dyn.icnt.icnt_lat.device == torch.device(device):
        return dyn
    return DynConfig.from_flat({k: v.to(device)
                                for k, v in dyn.flat().items()}, device)


def split_sm(part: dict, devices) -> list:
    """A per-SM state part ``(L, n_sm, …)`` as ``len(devices)`` blocks of
    contiguous SM positions, block ``i`` on ``devices[i]``, each leaf a
    contiguous tensor of its own (a slice of several lanes is not)."""
    n = next(iter(part.values())).shape[1] // len(devices)
    return [{k: v[:, i * n:(i + 1) * n].to(d).contiguous()
             for k, v in part.items()} for i, d in enumerate(devices)]


def gather_sm(blocks: list, device) -> dict:
    """The inverse of ``split_sm``: the blocks concatenated along the SM
    axis on ``device``."""
    if len(blocks) == 1:
        return tree_to(blocks[0], device)
    return {k: torch.cat([b[k].to(device) for b in blocks], 1)
            for k in blocks[0]}


def shard_state(state: dict, devices) -> dict:
    """A whole state as a group state over ``devices``: per-SM parts split
    into blocks, the rest on ``devices[0]``."""
    return {k: split_sm(v, devices) if k in SHARDED_PARTS
            else tree_to(v, devices[0]) for k, v in state.items()}


def unshard_state(state: dict, device) -> dict:
    """The inverse of ``shard_state``: the whole state on ``device``."""
    return {k: gather_sm(v, device) if k in SHARDED_PARTS
            else tree_to(v, device) for k, v in state.items()}


def _block_state(state: dict, i: int) -> dict:
    """Block ``i`` of a group state as a whole state of one block's SMs,
    its ``ctrl`` on the block's device."""
    dev = block_device(state["warp"][i])
    return dict(state, ctrl=tree_to(state["ctrl"], dev),
                **{k: state[k][i] for k in SHARDED_PARTS})


def reset_group(state: dict, cfg) -> dict:
    """``reset_for_kernel`` of a group state: each block reset on its own
    device; ``cfg`` has one block's shape (``n_sm`` the block's SMs)."""
    outs = [reset_for_kernel(_block_state(state, i), cfg)
            for i in range(len(state["warp"]))]
    # block 0 lies on the group's first device, with ctrl, mem and stats
    return dict(outs[0], **{k: [o[k] for o in outs] for k in SHARDED_PARTS})


def select_group(pred, new: dict, old: dict) -> dict:
    """``engine._select`` of group states: ``pred`` goes to each block's
    device once."""
    return {k: [_select(pred.to(block_device(n)), n, o)
                for n, o in zip(new[k], old[k])] if k in SHARDED_PARTS
            else _select(pred, new[k], old[k]) for k in new}


def group_converged(ctrl: dict, warp: list, req: list, traces: list):
    """``engine.converged`` of an 'sm' group, on ctrl's device: every
    block's verdict (on its device, with its copy of the trace) joined.
    The reference's ``psum`` of the live and busy counts over 'sm' is
    zero exactly when every block's is, so the verdict is the whole
    machine's."""
    home = ctrl["cycle"].device
    done = None
    for w, r, tr in zip(warp, req, traces):
        dev = block_device(w)
        c = {k: ctrl[k].to(dev) for k in ("cycle", "next_cta")}
        d = converged(c, w, r, tr).to(home)
        done = d if done is None else done & d
    return done


def group_counts(state: dict, traces: list | None = None) -> dict:
    """``telemetry.sm_counts`` of a group state: the blocks' counts added
    on ctrl's device (the reference's ``psum`` over 'sm'); with
    ``traces`` (one copy per block) the idle SMs too."""
    home = state["ctrl"]["cycle"].device
    per = [telemetry.sm_counts(w, r, s, None if traces is None
                               else traces[i]["n_instr"])
           for i, (w, r, s) in enumerate(zip(state["warp"], state["req"],
                                             state["stats_sm"]))]
    return {k: sum(c[k].to(home) for c in per) for k in per[0]}


# ---------------------------------------------------------------------------
# the sharded quantum
# ---------------------------------------------------------------------------

def make_shard_body(cfg, n_dev: int, exchange: str = "window"):
    """The quantum step of one 'sm' group of ``n_dev`` devices.

    ``body(warp, sm, req, stats_sm, mem, ctrl, gstats, trace, dyn)``:
    warp/sm/req/stats_sm are the group's blocks (lists, position order);
    mem/ctrl/gstats lie on the group's first device; ``trace`` and ``dyn``
    are lists with one copy per block, on the block's device (copy 0 on
    the first device).  The serial region gathers the request table and
    the warp table onto the first device, runs ``mem_phase`` (with
    ``ctrl['sm_ids']``) and ``cta_issue`` on the full tables with the full
    StaticConfig, and sends each device its slice; then every block runs
    Δ cycles of its SMs on its device, and ``group_converged`` reads every
    block: the whole machine's verdict.

    exchange='window' — one ``sm_quantum`` call per block per quantum (the
    lookahead window).  exchange='cycle' — Δ single cycles per block
    (``sim/smcore.py:sm_cycle``, which launches ``sm_issue`` on the card),
    the blocks' request tables gathered onto the first device after every
    cycle: the paper's per-cycle barrier.  Nothing reads that gather (no
    request issued inside a quantum is served before its end), so the
    results are bit-identical; only the traffic differs."""
    scfg = static_part(cfg)
    assert scfg.n_sm % n_dev == 0, (scfg.n_sm, n_dev)
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r} (expected "
                         f"{'/'.join(EXCHANGES)})")

    def body(warp, sm, req, stats_sm, mem, ctrl, gstats, trace, dyn):
        home = ctrl["cycle"].device
        devs = [block_device(w) for w in warp]
        t0 = ctrl["cycle"]
        # --- serial region, once per group on its first device ----------
        req_f, mem, gstats = mem_phase(gather_sm(req, home), mem, gstats,
                                       t0, scfg, dyn[0],
                                       sm_ids=ctrl["sm_ids"])
        warp_f, ctrl, gstats = cta_issue(gather_sm(warp, home), dict(ctrl),
                                         gstats, trace[0], scfg)
        req_l, warp_l = split_sm(req_f, devs), split_sm(warp_f, devs)
        t0s = [t0.to(d) for d in devs]
        # --- parallel region: every block on its device -----------------
        if exchange == "cycle":
            runs = [sm_cycles_eager(warp_l[i], sm[i], req_l[i], stats_sm[i],
                                    trace[i], t0s[i], scfg, dyn[i])
                    for i in range(n_dev)]
            for _ in range(scfg.quantum):
                torch.cat([next(r).to(home) for r in runs], 1)
            outs = [finish(r) for r in runs]
        else:
            outs = [sm_quantum(warp_l[i], sm[i], req_l[i], stats_sm[i],
                               trace[i], t0s[i], scfg, dyn[i])
                    for i in range(n_dev)]
        warp_l, sm, req_l, stats_sm = (list(p) for p in zip(*outs))
        # --- done detection over the whole group -----------------------
        cycle_end = t0 + scfg.quantum
        ctrl = dict(stamp_done(ctrl, group_converged(ctrl, warp_l, req_l,
                                                     trace), cycle_end),
                    cycle=cycle_end)
        return warp_l, sm, req_l, stats_sm, mem, ctrl, gstats

    return body


def make_sharded_quantum(cfg, n_dev: int, exchange: str = "window"):
    """The whole quantum step of a group state over ``n_dev`` blocks (the
    engine's ``quantum_step`` counterpart; the reference takes the mesh
    and reads its 'sm' axis size): ``step(state, trace, dyn)``, trace and
    dyn one copy per block as ``make_shard_body`` takes them, the counter
    timeline included.

    exchange='window' — one gather and one scatter of the tables per
    quantum (the lookahead window).  exchange='cycle' — a gather every
    cycle as well, the paper's per-cycle barrier; results are
    bit-identical, only the traffic differs."""
    scfg = static_part(cfg)
    body = make_shard_body(scfg, n_dev, exchange)

    def step(state, trace, dyn):
        warp, sm, req, stats_sm, mem, ctrl, gstats = body(
            state["warp"], state["sm"], state["req"], state["stats_sm"],
            state["mem"], state["ctrl"], state["stats"], trace, dyn)
        out = {"warp": warp, "sm": sm, "req": req, "mem": mem,
               "ctrl": ctrl, "stats_sm": stats_sm, "stats": gstats}
        if "telem" in state:
            out["telem"] = telemetry.quantum_update(
                state["telem"], out, trace[0], scfg,
                counts=group_counts(out, trace))
        return out

    return step


def run_kernel_groups(states: list, traces: list, dyns: list, step, cfg,
                      max_cycles: int = 1 << 20,
                      early_exit: bool = True) -> list:
    """One kernel's quantum loop for several independent group states (the
    'cfg' groups of a mesh), lanes in lockstep within each group as in
    ``engine.run_kernel``.  ``traces[g]`` and ``dyns[g]``: group ``g``'s
    copies, one per block.

    Each quantum issues the step of every group still running before it
    reads any group's ``running`` flag, an order that would let groups on
    distinct cards overlap; one host thread issues every launch, which
    prevents that today (PERF.md §7).  Each group reads its flag once per
    quantum, as the engine does.  With telemetry on, every lane then
    takes the kernel's forced end sample."""
    scfg = static_part(cfg)
    states = list(states)
    if early_exit:
        states = [dict(st, ctrl=stamp_done(
                      st["ctrl"], group_converged(st["ctrl"], st["warp"],
                                                  st["req"], tr),
                      st["ctrl"]["cycle"]))
                  for st, tr in zip(states, traces)]

    def running(st):
        ctrl = st["ctrl"]
        return (ctrl["done_cycle"] < 0) & (ctrl["cycle"] < max_cycles)

    run = [running(st) for st in states]
    go = [bool(r.any()) for r in run]
    while any(go):
        for g, st in enumerate(states):
            if go[g]:
                new = step(st, traces[g], dyns[g])
                # one lane that runs needs no select
                states[g] = new if run[g].shape[0] == 1 else \
                    select_group(run[g], new, st)
                run[g] = running(states[g])
        go = [go[g] and bool(run[g].any()) for g in range(len(states))]
    if telemetry.enabled(scfg):
        states = [dict(st, telem=telemetry.sample(
                      st["telem"], st, scfg, force=True,
                      counts=group_counts(st)))
                  for st in states]
    return states


def run_kernel_sharded(state, trace, cfg, mesh, max_cycles: int = 1 << 20,
                       exchange: str = "window", dyn=None,
                       early_exit: bool = True):
    """One kernel of a whole state (every lane) with its SM axis sharded
    over the mesh's 'sm' axis; returns the whole final state on the
    state's device.  ``trace``: the lanes' packed kernel; ``dyn``: their
    DynConfig (default: ``cfg``'s, one copy per lane).  A kernel runner
    for ``engine.run_workload``."""
    scfg = static_part(cfg)
    home = state["ctrl"]["cycle"].device
    if dyn is None:
        n = state["ctrl"]["cycle"].shape[0]
        dyn = split_config(cfg, device=home)[1].map(
            lambda x: x.expand(n, *x.shape))
    devs = sm_devices(mesh)
    [st] = run_kernel_groups(
        [shard_state(state, devs)], [[tree_to(trace, d) for d in devs]],
        [[dyn_to(dyn, d) for d in devs]],
        make_sharded_quantum(scfg, len(devs), exchange), scfg, max_cycles,
        early_exit)
    return unshard_state(st, home)


# ---------------------------------------------------------------------------
# SM→device assignment (the OpenMP scheduler's analogue)
# ---------------------------------------------------------------------------

def sm_permutation(cfg, n_devices: int, policy: str = "static") -> np.ndarray:
    sms = np.arange(cfg.n_sm)
    if policy == "static":
        return sms
    if policy == "dynamic":
        # deal SMs round-robin to devices, then concatenate per-device lists
        per_dev = [sms[d::n_devices] for d in range(n_devices)]
        return np.concatenate(per_dev)
    raise ValueError(policy)


def permute_state(state: dict, perm) -> dict:
    """Relabel the SM axis of every lane: array position p now holds SM
    ``perm[p]``.  ``ctrl.sm_ids`` records the original ids, so CTA
    dispatch (round-robin over original ids) and the memory system's
    tie-break order are unchanged; only the device placement changes.
    Indexing yields fresh contiguous tensors."""
    idx = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                          device=state["ctrl"]["cycle"].device)
    out = dict(state)
    for part in SHARDED_PARTS:
        out[part] = {k: v[:, idx] for k, v in state[part].items()}
    out["ctrl"] = dict(state["ctrl"], sm_ids=state["ctrl"]["sm_ids"][:, idx])
    return out

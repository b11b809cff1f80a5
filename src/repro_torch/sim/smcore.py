"""SM phase — the parallel region, vectorized over a leading SM axis.

``sm_quantum`` simulates Δ cycles of every SM it is given, touching only
each SM's own state (warps, L1, its MSHR rows, its stats).  ``vmap`` mode
hands it all SMs at once; ``seq`` mode one SM at a time
(core/parallel.py).  On CUDA tensors it is one launch of the fused
``sm_quantum`` kernel (kernels/sm_quantum: one thread block per SM, the
state in shared memory for the whole quantum, no host read); on CPU
tensors it runs ``sm_quantum_eager``, the cycle loop below, which is that
kernel's plain version.

One cycle, per SM, as in ``repro.sim.smcore.sm_cycle_single``: deliver
resolved memory responses, release CTA barriers, then let each sub-core
issue at most one instruction.  The eager loop splits the reference's
per-sub-core step (``_issue_subcore``) three ways, to batch its tensor
operations over SMs and sub-cores:

  1. warp selection for every SM and sub-core in one call of the
     ``sm_issue`` kernel, which returns two winners per sub-core: any op
     (``sel_open``) and no LDG/STG (``sel_closed``);
  2. ``_issue_subcore``, in sub-core order: the MSHR free-row gate picks
     between the two winners, then the L1 probe, the unique-address set
     and MSHR allocation — the only state that sub-cores of one SM share
     within a cycle;
  3. ``_commit``, batched over sub-cores: scoreboard, dispatch port,
     last-issued warp and stats.  Sub-cores own disjoint warp slots, ports
     and last-issued slots, so the order does not matter there.

Each quantum and each cycle of the eager loop read back a few flags, so
that steps which would change nothing are skipped: a quantum for SMs with
nothing to do, barrier release when no warp can be at a barrier, the issue
steps when no SM issues, the memory side of a sub-core that issues no
LDG/STG.  Every result is bit-identical to the reference.

Lanes: the state carries a leading lane axis ``(L, n_sm, …)``, each lane
with its own trace, ``instr_base``, dynamic config and clock ``t0``.  The
eager loop flattens lanes and SMs into ``L · n_sm`` SM rows, each row
carrying its lane's trace scalars, clock and timing tables (SMs never
interact within a quantum); warp selection is one call of the plain
version on the CPU and one ``sm_issue`` launch per lane on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sm_issue.kernel import issue_select, unit_table
from repro_torch.kernels.sm_quantum.kernel import sm_quantum as fused_quantum
from repro_torch.sim.config import (BAR, LDG, N_UNITS, STG, DynConfig,
                                    StaticConfig)
from repro_torch.sim.trace import gen_address

_U32 = 0xFFFFFFFF
_N_PROBES = 4


def _deliver(warp, req, t):
    """Deliver resolved responses: free the rows, count down loads.
    ``t``: (rows, 1) clock of each SM row."""
    done = (req["stage"] == 3) & (req["t"] <= t)
    dec = torch.zeros_like(warp["pending"]).scatter_add(
        1, req["warp"].long(), (done & ~req["is_store"]).int())
    warp = dict(warp, pending=warp["pending"] - dec)
    req = dict(req, stage=torch.where(done, 0, req["stage"]))
    return warp, req


def _release_barriers(warp, n_instr, t):
    """CTA barrier: a waiting warp resumes once every active warp of its
    CTA has either arrived at the barrier or finished the kernel.
    Pairwise over the warp slots of one SM: (n_sm, W, W) booleans."""
    cta = warp["cta"]
    arrived = warp["wait_bar"] | (warp["pc"] >= n_instr)
    same = warp["active"][:, None, :] & (cta[:, :, None] == cta[:, None, :])
    waiting = (same & ~arrived[:, None, :]).any(2)
    release = warp["wait_bar"] & ~waiting
    return dict(warp,
                wait_bar=warp["wait_bar"] & ~release,
                ready_at=torch.where(release, t, warp["ready_at"]))


def _l1_access(sm, addr, t, enable, cfg: StaticConfig):
    """One L1 probe per SM row at ``addr`` (rows,); returns the hit flags.
    Where ``enable``, the probed way takes the tag and the LRU time ``t``
    (rows,), in place in ``sm``."""
    ns = addr.shape[0]
    st = torch.remainder(addr, cfg.l1_sets).long()
    rows = torch.arange(ns, device=addr.device)
    match = sm["l1_tag"][rows, st] == addr[:, None]    # (ns, ways)
    hit = match.any(1)
    victim = sm["l1_lru"][rows, st].argmin(1)
    way = torch.where(hit, match.int().argmax(1), victim)
    idx = (st * cfg.l1_ways + way)[:, None]
    tag = sm["l1_tag"].view(ns, -1)
    lru = sm["l1_lru"].view(ns, -1)
    # on a hit the tag already holds addr
    tag.scatter_(1, idx, torch.where(enable, addr,
                                     tag.gather(1, idx)[:, 0])[:, None])
    lru.scatter_(1, idx, torch.where(enable, t,
                                     lru.gather(1, idx)[:, 0])[:, None])
    return hit


def _addrset_insert(sm, addr, enable, cfg: StaticConfig):
    """Bounded open-addressing set insert, 4 linear probes from a
    multiplicative hash (uint32 arithmetic done in int64), in place in
    ``sm``.

    The reference probes one slot at a time; a probe writes only when it
    inserts, which ends the probing, so the first probe that finds the
    address or an empty slot decides, and all probes can read at once."""
    cap = cfg.addrset_cap
    aset = sm["addrset"]
    h = torch.remainder((addr.long() * 2654435761) & _U32, cap)
    probes = torch.arange(_N_PROBES, device=addr.device)
    slots = torch.remainder(h[:, None] + probes, cap)          # (ns, 4)
    cur = aset.gather(1, slots)
    ok = (cur == addr[:, None]) | (cur == -1)
    found = ok.any(1)
    first = ok.int().argmax(1, keepdim=True)
    cur_f = cur.gather(1, first)[:, 0]
    new = torch.where(enable & found & (cur_f == -1), addr, cur_f)
    aset.scatter_(1, slots.gather(1, first), new[:, None])
    sm["addrset_over"] = sm["addrset_over"] + (enable & ~found).int()


def _issue_subcore(sm, req, addr, t, mem_cand, sel_store, sel_warp,
                   cfg: StaticConfig, dyn: DynConfig):
    """The memory side of one sub-core's issue, for every SM row at once.

    ``mem_cand`` (rows,): the sub-core's ``sel_open`` winner is an LDG/STG
    (whose address is ``addr``, store flag ``sel_store``, warp slot
    ``sel_warp``).  It issues only while the SM still has a free MSHR row,
    after the allocations of lower sub-cores this cycle; otherwise the
    sub-core takes its ``sel_closed`` winner.  ``t`` and ``dyn``'s leaves
    are per SM row, (rows, 1).  Updates ``sm`` in place; returns (req,
    use_open, mem_issue, hit)."""
    free = req["stage"] == 0
    use_open = free.any(1)
    mem_issue = mem_cand & use_open
    hit = _l1_access(sm, addr, t[:, 0], mem_issue, cfg)
    _addrset_insert(sm, addr, mem_issue, cfg)
    # MSHR allocation on miss: the first free row
    alloc = (free & (torch.cumsum(free.int(), 1) == 1)
             & (mem_issue & ~hit)[:, None])
    req = dict(
        req,
        stage=torch.where(alloc, 1, req["stage"]),
        addr=torch.where(alloc, addr[:, None], req["addr"]),
        t=torch.where(alloc, t + dyn.icnt.icnt_lat, req["t"]),
        warp=torch.where(alloc, sel_warp[:, None], req["warp"]),
        is_store=torch.where(alloc, sel_store[:, None], req["is_store"]),
    )
    return req, use_open, mem_issue, hit


def _fetch(warp, trace, sel, subcores):
    """Warp slot, clipped pc and op of each sub-core's winner ``sel``
    (rows, SC); a sub-core without a winner reads its first slot, as the
    reference's argmin does, and nothing it reads is used.  ``trace``
    holds one row per SM row (``_row_trace``)."""
    n_instr = trace["n_instr"]
    do = sel >= 0
    wsel = torch.where(do, sel, subcores).long()
    spc = torch.clamp(warp["pc"].gather(1, wsel), min=0).minimum(n_instr - 1)
    # (an empty kernel, n_instr = 0, reads slot 0: it has no winner)
    fetch = (trace["instr_base"] + spc).clamp(min=0).long()
    return do, wsel, spc, fetch, trace["ops"].gather(1, fetch)


def _commit(warp, sm, stats, trace, t, do, wsel, spc, sop, mem_issue, hit,
            dyn: DynConfig):
    """Scoreboard, dispatch port, last-issued warp and issue stats of the
    final winners, all sub-cores at once (they own disjoint warp slots)."""
    n_instr = trace["n_instr"]
    l1_miss = mem_issue & ~hit
    lat = torch.where(sop == LDG,
                      torch.where(hit, dyn.cache.l1_hit_lat, 1),
                      dyn.core.lat.gather(1, sop.long()))
    nxt = spc + 1
    dep_next = (nxt < n_instr) & trace["dep"].gather(
        1, (trace["instr_base"] + nxt.minimum(n_instr - 1)).clamp(
            min=0).long())
    wait_lat = torch.where(dep_next, torch.clamp(lat, min=1), 1)

    def put(x, new):
        old = x.gather(1, wsel)
        return x.scatter(1, wsel, torch.where(do, new(old), old))

    warp = dict(
        warp,
        pc=put(warp["pc"], lambda old: spc + 1),
        ready_at=put(warp["ready_at"], lambda old: t + wait_lat),
        wait_mem=put(warp["wait_mem"], lambda old: dep_next & l1_miss),
        wait_bar=put(warp["wait_bar"], lambda old: old | (sop == BAR)),
        pending=put(warp["pending"],
                    lambda old: old + (l1_miss & (sop == LDG)).int()),
    )
    ns, sc = do.shape
    port = (torch.arange(sc, device=do.device) * N_UNITS
            + unit_table(do.device)[sop])
    unit_free = sm["unit_free"].view(ns, -1)
    busy = torch.where(do, t + dyn.core.disp.gather(1, sop.long()),
                       unit_free.gather(1, port))
    sm = dict(sm,
              unit_free=unit_free.scatter(1, port, busy).view_as(
                  sm["unit_free"]),
              last_issued=torch.where(do, wsel.int(), sm["last_issued"]))
    i32 = torch.int32
    stats = dict(stats,
                 issued=stats["issued"] + do.sum(1, dtype=i32),
                 issued_mem=stats["issued_mem"] + mem_issue.sum(1, dtype=i32),
                 l1_hit=stats["l1_hit"] + (mem_issue & hit).sum(1, dtype=i32),
                 l1_miss=stats["l1_miss"] + l1_miss.sum(1, dtype=i32))
    return warp, sm, stats


def _select(warp, sm, trace, lanes, t, n_subcores):
    """Warp selection for every SM row.  On the CPU one call of the plain
    version takes every row's own trace and clock; the kernel takes one
    trace and one clock per launch, so on the card there is one launch
    per lane.  ``lanes``: per lane, (first row, last row + 1, ops,
    n_instr, instr_base, sched)."""
    state = (warp["pc"], warp["active"], warp["ready_at"], warp["pending"],
             warp["wait_mem"], warp["wait_bar"], sm["last_issued"],
             sm["unit_free"])
    if warp["pc"].device.type == "cpu":
        return issue_select(*state, trace["ops"], trace["n_instr"],
                            trace["instr_base"], trace["sched"], t,
                            n_subcores=n_subcores)
    parts = [issue_select(*(x[a:b] for x in state), ops, n_instr, base,
                          sched, t[a, 0], n_subcores=n_subcores)
             for a, b, ops, n_instr, base, sched in lanes]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(2))


def sm_cycle(warp, sm, req, stats, trace, t, barriers: bool,
             cfg: StaticConfig, dyn: DynConfig, lanes):
    """One cycle of every SM row given (arrays with a leading axis of SM
    rows; ``trace``, ``t`` and ``dyn`` per row, from ``_row_trace`` and
    ``_row_dyn``; ``lanes`` as ``_select`` takes it); ``barriers``: some
    warp may wait at a CTA barrier.  Updates ``sm``'s L1 and address-set
    tensors in place."""
    n_instr = trace["n_instr"]
    nsc = cfg.n_subcores
    ns = warp["pc"].shape[0]
    i32 = torch.int32
    warp, req = _deliver(warp, req, t)
    if barriers:
        warp = _release_barriers(warp, n_instr, t)
    sel_open, sel_closed = _select(warp, sm, trace, lanes, t, nsc)
    subcores = torch.arange(nsc, device=t.device)
    do_o, wsel_o, spc_o, fetch_o, sop_o = _fetch(warp, trace, sel_open,
                                                 subcores)
    # an LDG/STG winner issues only while its SM has a free MSHR row; rows
    # free up only in _deliver, so an SM without one now takes sel_closed
    # on every sub-core this cycle
    free0 = (req["stage"] == 0).any(1, keepdim=True)
    is_mem = do_o & ((sop_o == LDG) | (sop_o == STG))
    mem_o = is_mem & free0
    # stall: a sub-core with a live warp that issues nothing this cycle
    exists = (warp["active"] & (warp["pc"] < n_instr)).view(
        ns, -1, nsc).any(1)
    flags = torch.cat([do_o.any().view(1), (is_mem & ~free0).any().view(1),
                       mem_o.any(0)]).tolist()

    if not flags[0]:
        return warp, sm, req, dict(
            stats,
            stall=stats["stall"] + exists.sum(1, dtype=i32),
            warp_cycles=stats["warp_cycles"]
            + warp["active"].sum(1, dtype=i32))

    hit = torch.zeros_like(do_o)
    mem_issue = torch.zeros_like(do_o)
    use_open = free0.expand(ns, nsc).clone()
    if any(flags[2:]):
        gwarp = (warp["cta"].gather(1, wsel_o) * trace["warps_per_cta"]
                 + warp["wic"].gather(1, wsel_o))
        addr = gen_address(trace["addr_mode"].gather(1, fetch_o),
                           trace["addr_param"].gather(1, fetch_o), gwarp,
                           spc_o, cfg.mem_blocks)
        for sc in range(nsc):
            if flags[2 + sc]:
                req, use_open[:, sc], mem_issue[:, sc], hit[:, sc] = \
                    _issue_subcore(sm, req, addr[:, sc], t, mem_o[:, sc],
                                   sop_o[:, sc] == STG, wsel_o[:, sc].int(),
                                   cfg, dyn)
    if flags[1] or any(flags[2:]):
        sel = torch.where(use_open, sel_open, sel_closed)
        do, wsel, spc, _, sop = _fetch(warp, trace, sel, subcores)
    else:
        # every winner issues as selected: sel_closed == sel_open
        do, wsel, spc, sop = do_o, wsel_o, spc_o, sop_o
    warp, sm, stats = _commit(warp, sm, stats, trace, t, do, wsel, spc, sop,
                              mem_issue, hit, dyn)
    stats = dict(
        stats,
        stall=stats["stall"] + (exists & ~do).sum(1, dtype=i32),
        cycles_issue=stats["cycles_issue"] + do.any(1).int(),
        warp_cycles=stats["warp_cycles"]
        + warp["active"].sum(1, dtype=i32),
    )
    return warp, sm, req, stats


def _row_trace(trace: dict, sched, n_lanes: int, ns: int) -> dict:
    """A lane-batched trace as one row per SM row: instruction arrays
    (rows, n), scalars (rows, 1); ``instr_base`` 0 where absent; and the
    lane's scheduler selector ``sched``."""
    def rows(x):
        return x.reshape(n_lanes, *x.shape[1:]).repeat_interleave(ns, 0)
    out = {f: rows(trace[f]) for f in ("ops", "dep", "addr_mode",
                                       "addr_param")}
    base = trace.get("instr_base")
    if base is None:
        base = torch.zeros_like(trace["n_instr"])
    for f, x in (("n_instr", trace["n_instr"]),
                 ("warps_per_cta", trace["warps_per_cta"]),
                 ("instr_base", base)):
        out[f] = rows(x.reshape(n_lanes, 1))
    out["sched"] = rows(sched.reshape(n_lanes, 1))
    return out


def _row_dyn(dyn: DynConfig, n_lanes: int, ns: int) -> DynConfig:
    """A lane-batched DynConfig as one row per SM row: scalars (rows, 1),
    tables (rows, N_CLASSES)."""
    return dyn.map(lambda x: x.reshape(n_lanes, -1).repeat_interleave(ns, 0))


def sm_cycles_eager(warp, sm, req, stats, trace, t0, cfg: StaticConfig,
                    dyn: DynConfig):
    """The eager loop one cycle at a time: a generator that runs Δ
    consecutive cycles for every lane and SM given (arguments as
    ``sm_quantum_eager`` takes them), yields the request table's
    ``stage`` ``(L, n_sm, M)`` after each cycle, and returns the final
    (warp, sm, req, stats) (``finish``).  SM-axis sharding steps several
    of them in turn, cycle by cycle (core/parallel.py, exchange='cycle').

    When no SM of any lane has an active warp, a request in flight or a
    warp at a barrier, the quantum changes nothing and the inputs are
    returned as they are; otherwise the L1 and address-set tensors are
    copied once and then updated in place, cycle by cycle."""
    n_lanes, ns = warp["pc"].shape[:2]
    busy, waiting, has_bar = torch.stack([
        warp["active"].any() | (req["stage"] != 0).any(),
        warp["wait_bar"].any(), (trace["ops"] == BAR).any()]).tolist()
    if not (busy or waiting):
        for _ in range(cfg.quantum):
            yield req["stage"]
        return warp, sm, req, stats
    barriers = waiting or has_bar

    def flat(part):
        return {k: v.reshape(n_lanes * ns, *v.shape[2:])
                for k, v in part.items()}

    def unflat(part):
        return {k: v.reshape(n_lanes, ns, *v.shape[1:])
                for k, v in part.items()}

    w, s, r, st = (flat(p) for p in (warp, sm, req, stats))
    s = dict(s, l1_tag=s["l1_tag"].clone(), l1_lru=s["l1_lru"].clone(),
             addrset=s["addrset"].clone())
    rows = _row_trace(trace, dyn.core.sched, n_lanes, ns)
    row_dyn = _row_dyn(dyn, n_lanes, ns)
    t_rows = t0.reshape(n_lanes, 1).repeat_interleave(ns, 0)
    lanes = None
    if warp["pc"].device.type != "cpu":     # the kernel's per-lane launches
        lanes = [(i * ns, (i + 1) * ns, trace["ops"].reshape(n_lanes, -1)[i],
                  rows["n_instr"][i * ns, 0], rows["instr_base"][i * ns, 0],
                  rows["sched"][i * ns, 0]) for i in range(n_lanes)]
    for i in range(cfg.quantum):
        w, s, r, st = sm_cycle(w, s, r, st, rows, t_rows + i, barriers, cfg,
                               row_dyn, lanes)
        yield r["stage"].reshape(req["stage"].shape)
    return tuple(unflat(p) for p in (w, s, r, st))


def finish(cycles):
    """Run a ``sm_cycles_eager`` generator to its end; returns its final
    (warp, sm, req, stats)."""
    try:
        while True:
            next(cycles)
    except StopIteration as stop:
        return stop.value


def sm_quantum_eager(warp, sm, req, stats, trace, t0, cfg: StaticConfig,
                     dyn: DynConfig):
    """Run Δ consecutive cycles for every lane and SM given — the
    communication window — as Δ calls of ``sm_cycle`` over the lanes' SM
    rows (``sm_cycles_eager`` run to its end).  On CUDA tensors it
    launches ``sm_issue`` once per cycle and lane.

    State leaves ``(L, n_sm, …)``; ``trace``'s instruction arrays
    ``(L, n)`` (one row per lane, or a row shared through a stride of
    0) and scalars ``(L,)``, ``instr_base`` optional; ``t0`` ``(L,)``;
    ``dyn``'s leaves ``(L,)`` and ``(L, N_CLASSES)``.  A quantum that
    changes nothing returns the inputs as they are."""
    return finish(sm_cycles_eager(warp, sm, req, stats, trace, t0, cfg,
                                  dyn))


def sm_quantum(warp, sm, req, stats, trace, t0, cfg: StaticConfig,
               dyn: DynConfig):
    """The SM phase: Δ cycles of every lane and SM given (arguments as
    ``sm_quantum_eager`` takes them).  CUDA tensors go to one launch of
    the fused ``sm_quantum`` kernel for all lanes; CPU tensors run its
    plain version, ``sm_quantum_eager``.  Returns fresh (warp, sm, req,
    stats) dicts; the inputs are not modified."""
    if warp["pc"].device.type == "cpu":
        return sm_quantum_eager(warp, sm, req, stats, trace, t0, cfg, dyn)
    return fused_quantum(warp, sm, req, stats, trace, t0, cfg, dyn)

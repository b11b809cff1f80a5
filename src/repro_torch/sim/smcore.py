"""SM phase — the parallel region, vectorized over a leading SM axis.

``sm_quantum`` simulates Δ cycles of every SM it is given, touching only
each SM's own state (warps, L1, its MSHR rows, its stats).  ``vmap`` mode
hands it all SMs at once; ``seq`` mode one SM at a time
(core/parallel.py).

One cycle, per SM, as in ``repro.sim.smcore.sm_cycle_single``: deliver
resolved memory responses, release CTA barriers, then let each sub-core
issue at most one instruction.  The reference's per-sub-core step
(``_issue_subcore``) is split three ways here:

  1. warp selection for every SM and sub-core in one call of the
     ``sm_issue`` kernel, which returns two winners per sub-core: any op
     (``sel_open``) and no LDG/STG (``sel_closed``);
  2. ``_issue_subcore``, in sub-core order: the MSHR free-row gate picks
     between the two winners, then the L1 probe, the unique-address set
     and MSHR allocation — the only state that sub-cores of one SM share
     within a cycle;
  3. ``_commit``, batched over sub-cores: scoreboard, dispatch port,
     last-issued warp and stats.  Sub-cores own disjoint warps, ports and
     last-issued slots, so the order does not matter there.

Each quantum and each cycle read back a few flags, so that steps which
would change nothing are skipped: a quantum for SMs with nothing to do,
barrier release when no warp can be at a barrier, the issue steps when no
SM issues, the memory side of a sub-core that issues no LDG/STG.  Every
result is bit-identical to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sm_issue.kernel import issue_select, unit_table
from repro_torch.sim.config import (BAR, LDG, N_UNITS, STG, DynConfig,
                                    StaticConfig)
from repro_torch.sim.trace import gen_address

_U32 = 0xFFFFFFFF
_N_PROBES = 4


def _deliver(warp, req, t):
    """Deliver resolved responses: free the rows, count down loads."""
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
    """One L1 probe per SM at ``addr`` (n_sm,); returns the hit flags.
    Where ``enable``, the probed way takes the tag and the LRU time, in
    place in ``sm``."""
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
    """The memory side of one sub-core's issue, for every SM at once.

    ``mem_cand`` (n_sm,): the sub-core's ``sel_open`` winner is an LDG/STG
    (whose address is ``addr``, store flag ``sel_store``, warp slot
    ``sel_warp``).  It issues only while the SM still has a free MSHR row,
    after the allocations of lower sub-cores this cycle; otherwise the
    sub-core takes its ``sel_closed`` winner.  Updates ``sm`` in place;
    returns (req, use_open, mem_issue, hit)."""
    free = req["stage"] == 0
    use_open = free.any(1)
    mem_issue = mem_cand & use_open
    hit = _l1_access(sm, addr, t, mem_issue, cfg)
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


def _fetch(warp, trace, sel, lanes):
    """Warp slot, clipped pc and op of each sub-core's winner ``sel``
    (n_sm, SC); a sub-core without a winner reads its first slot, as the
    reference's argmin does, and nothing it reads is used."""
    n_instr = trace["n_instr"]
    do = sel >= 0
    wsel = torch.where(do, sel, lanes).long()
    spc = torch.clamp(warp["pc"].gather(1, wsel), min=0).minimum(n_instr - 1)
    fetch = trace["instr_base"] + spc
    return do, wsel, spc, fetch, trace["ops"][fetch]


def _commit(warp, sm, stats, trace, t, do, wsel, spc, sop, mem_issue, hit,
            dyn: DynConfig):
    """Scoreboard, dispatch port, last-issued warp and issue stats of the
    final winners, all sub-cores at once (they own disjoint warp slots)."""
    n_instr = trace["n_instr"]
    l1_miss = mem_issue & ~hit
    lat = torch.where(sop == LDG,
                      torch.where(hit, dyn.cache.l1_hit_lat, 1),
                      dyn.core.lat[sop])
    nxt = spc + 1
    dep_next = (nxt < n_instr) & trace["dep"][
        trace["instr_base"] + nxt.minimum(n_instr - 1)]
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
    busy = torch.where(do, t + dyn.core.disp[sop], unit_free.gather(1, port))
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


def sm_cycle(warp, sm, req, stats, trace, t, barriers: bool,
             cfg: StaticConfig, dyn: DynConfig):
    """One cycle of every SM given (arrays with the leading SM axis).
    ``trace`` must carry ``instr_base`` (0 in the padded layout);
    ``barriers``: some warp may wait at a CTA barrier.  Updates ``sm``'s
    L1 and address-set tensors in place."""
    n_instr = trace["n_instr"]
    nsc = cfg.n_subcores
    ns = warp["pc"].shape[0]
    i32 = torch.int32
    warp, req = _deliver(warp, req, t)
    if barriers:
        warp = _release_barriers(warp, n_instr, t)
    sel_open, sel_closed = issue_select(
        warp["pc"], warp["active"], warp["ready_at"], warp["pending"],
        warp["wait_mem"], warp["wait_bar"], sm["last_issued"],
        sm["unit_free"], trace["ops"], n_instr, trace["instr_base"],
        dyn.core.sched, t, n_subcores=nsc)
    lanes = torch.arange(nsc, device=t.device)
    do_o, wsel_o, spc_o, fetch_o, sop_o = _fetch(warp, trace, sel_open,
                                                 lanes)
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
        addr = gen_address(trace["addr_mode"][fetch_o],
                           trace["addr_param"][fetch_o], gwarp, spc_o,
                           cfg.mem_blocks)
        for sc in range(nsc):
            if flags[2 + sc]:
                req, use_open[:, sc], mem_issue[:, sc], hit[:, sc] = \
                    _issue_subcore(sm, req, addr[:, sc], t, mem_o[:, sc],
                                   sop_o[:, sc] == STG, wsel_o[:, sc].int(),
                                   cfg, dyn)
    if flags[1] or any(flags[2:]):
        sel = torch.where(use_open, sel_open, sel_closed)
        do, wsel, spc, _, sop = _fetch(warp, trace, sel, lanes)
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


def sm_quantum(warp, sm, req, stats, trace, t0, cfg: StaticConfig,
               dyn: DynConfig):
    """Run Δ consecutive cycles for every SM given — the communication
    window.

    SMs with no active warp, no request in flight and no warp at a
    barrier do nothing for the whole quantum and are returned as they
    are; otherwise the L1 and address-set tensors are copied once and
    then updated in place, cycle by cycle."""
    if "instr_base" not in trace:
        trace = dict(trace, instr_base=torch.zeros_like(trace["n_instr"]))
    busy, waiting, has_bar = torch.stack([
        warp["active"].any() | (req["stage"] != 0).any(),
        warp["wait_bar"].any(), (trace["ops"] == BAR).any()]).tolist()
    if not (busy or waiting):
        return warp, sm, req, stats
    barriers = waiting or has_bar
    sm = dict(sm, l1_tag=sm["l1_tag"].clone(), l1_lru=sm["l1_lru"].clone(),
              addrset=sm["addrset"].clone())
    for i in range(cfg.quantum):
        warp, sm, req, stats = sm_cycle(warp, sm, req, stats, trace, t0 + i,
                                        barriers, cfg, dyn)
    return warp, sm, req, stats

"""Memory-system phase: interconnect → L2 slices → DRAM channels.

Runs once per machine quantum (Δ cycles) over the full request table —
the serial region.  Queueing at L2 slices and DRAM channels is the exact
recurrence
  finish_i = max(arrival_i, finish_{i-1}) + service_i
over requests sorted by (resource, event time, row id), carried across
quanta through ``busy_until``.

Every step reproduces ``repro.sim.memsys`` bit for bit, and every step is
free of host syncs: masked writes go to a spare slot past the end of the
array instead of through boolean indexing, and no scatter ever has two
writes to one live index (the order of such writes is undefined on CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import DynConfig, StaticConfig
from repro_torch.sim.trace import wrap_i32

BIG = 1 << 30
_SEG = 1 << 40      # per-segment offset of the segmented cummax


def _seg_maxplus(seg_start, service, arrival):
    """finish_i = max(arrival_i, finish_{i-1}) + service_i, reset at segment
    starts.  All inputs sorted by segment; seg_start: bool (first of seg).

    Closed form: with S_i the in-segment prefix sum of ``service``,
    finish_i = S_i + max_{j ≤ i in the segment}(arrival_j + service_j - S_j).
    The in-segment max is a cummax over the whole array after offsetting
    segment k by k·2^40 (values stay far below 2^40)."""
    service = service.long()
    csum = torch.cumsum(service, 0)
    seg_base = torch.cummax(torch.where(seg_start, csum - service, 0), 0)[0]
    s_in = csum - seg_base
    seg_off = (torch.cumsum(seg_start.long(), 0) - 1) * _SEG
    run = torch.cummax(arrival.long() + service - s_in + seg_off, 0)[0]
    return (s_in + run - seg_off).to(torch.int32)


def _lex_sort(primary, secondary, tertiary, valid):
    """argsort by (primary, secondary, tertiary), invalid rows last.

    Two stable passes like the reference: ``secondary * r + tertiary``
    packed into one int32 key (with the reference's wraparound), then a
    stable pass on ``primary``.  ``secondary`` must be small: callers pass
    the quantum-relative event time ``t - t0``."""
    r = tertiary.shape[0]
    k2 = wrap_i32(secondary.long() * r + tertiary.long())
    k2 = torch.where(valid, k2, BIG)
    o1 = torch.argsort(k2, stable=True)
    p = torch.where(valid, primary, BIG)[o1]
    o2 = torch.argsort(p, stable=True)
    return o1[o2]


def _set_masked(flat, idx, vals, mask):
    """``flat[idx] = vals`` where ``mask``; the other rows write into a
    spare slot past the end, which is then dropped.  Live indices must be
    unique."""
    n = flat.shape[0]
    ext = torch.cat([flat, flat[:1]])
    ext = ext.scatter(0, torch.where(mask, idx, n), vals.to(flat.dtype))
    return ext[:n]


def mem_phase(req: dict, mem: dict, stats: dict, t0, cfg: StaticConfig,
              dyn: DynConfig, sm_ids=None):
    """Process the event horizon [t0, t0+Δ). Returns (req, mem, stats).

    ``sm_ids``: (n_sm,) ORIGINAL SM id per array position, the canonical
    tie-break order."""
    ns, m = req["stage"].shape
    r = ns * m
    dev = req["stage"].device
    t0 = torch.as_tensor(t0, dtype=torch.int32, device=dev)
    horizon = t0 + cfg.quantum
    stage = req["stage"].reshape(r)
    addr = req["addr"].reshape(r)
    t = req["t"].reshape(r)
    if sm_ids is None:
        sm_ids = torch.arange(ns, dtype=torch.int32, device=dev)
    rid = (sm_ids[:, None] * m
           + torch.arange(m, dtype=torch.int32, device=dev)[None, :]
           ).reshape(r)
    first = torch.zeros((r,), dtype=torch.bool, device=dev)
    first[0] = True

    # ---------------- stage 1: arrival at L2 slices -------------------------
    sel1 = (stage == 1) & (t < horizon)
    slc = torch.remainder(addr, cfg.l2_slices)
    order = _lex_sort(slc, t - t0, rid, sel1)
    o_sel = sel1[order]
    o_slc = torch.where(o_sel, slc[order], cfg.l2_slices)
    o_t = t[order]
    o_addr = addr[order]

    seg_start = first.clone()
    seg_start[1:] = o_slc[1:] != o_slc[:-1]
    slc_c = torch.clamp(o_slc, 0, cfg.l2_slices - 1).long()
    arrival = torch.maximum(o_t, mem["l2_busy"][slc_c])
    service = torch.ones((r,), dtype=torch.int32, device=dev)
    finish = _seg_maxplus(seg_start, service, arrival)
    start = finish - service

    # L2 tag lookup (snapshot at quantum start)
    l2_set = torch.remainder(
        torch.div(o_addr, cfg.l2_slices, rounding_mode="floor"),
        cfg.l2_sets).long()
    ways = mem["l2_tag"][slc_c, l2_set]          # (r, ways)
    match = ways == o_addr[:, None]
    hit = match.any(1) & o_sel
    miss = o_sel & ~hit

    resp_t = start + dyn.cache.l2_lat + dyn.icnt.icnt_lat
    dram_t = start + dyn.cache.l2_lat + dyn.mem.part_lat

    new_stage = torch.where(hit, 3, torch.where(miss, 2, stage[order]))
    new_t = torch.where(hit, resp_t, torch.where(miss, dram_t, o_t))
    # scatter back (order is a permutation: unique indices)
    stage = torch.empty_like(stage).scatter(0, order, new_stage.int())
    t = torch.empty_like(t).scatter(0, order, new_t.int())

    # busy_until per slice: max finish (scatter-max is order-free)
    l2_busy = mem["l2_busy"].scatter_reduce(
        0, slc_c, torch.where(o_sel, finish, 0), "amax")

    # LRU touch on hits (monotone time: scatter-max is exact)
    n_ways = cfg.l2_ways
    cell = (slc_c * cfg.l2_sets + l2_set) * n_ways      # flat (slice, set)
    hway = match.to(torch.uint8).argmax(1)
    l2_lru = mem["l2_lru"].reshape(-1).scatter_reduce(
        0, cell + hway, torch.where(hit, t0, -1).int(), "amax")
    # insert on miss: victim = LRU way; same-(slice, set) conflicts go to
    # the last row in canonical order (scatter-max of the rank, then only
    # the winner writes its tag)
    cell_ways = cell[:, None] + torch.arange(n_ways, device=dev)
    victim = l2_lru[cell_ways].argmin(1)
    vidx = cell + victim
    rank = torch.arange(r, dtype=torch.int32, device=dev)
    rank_grid = torch.full_like(l2_lru, -1).scatter_reduce(
        0, vidx, torch.where(miss, rank, -1), "amax")
    win = miss & (rank_grid[vidx] == rank)
    l2_tag = _set_masked(mem["l2_tag"].reshape(-1), vidx, o_addr, win)
    l2_lru = _set_masked(l2_lru, vidx, t0.expand(r), win)

    stats = dict(stats,
                 l2_hit=stats["l2_hit"] + hit.sum(dtype=torch.int32),
                 l2_miss=stats["l2_miss"] + miss.sum(dtype=torch.int32))

    # ---------------- stage 2: DRAM channels --------------------------------
    n_ch = cfg.dram_channels
    sel2 = (stage == 2) & (t < horizon)
    ch = torch.div(torch.remainder(addr, cfg.l2_slices) * n_ch,
                   cfg.l2_slices, rounding_mode="floor")
    order2 = _lex_sort(ch, t - t0, rid, sel2)
    o_sel2 = sel2[order2]
    o_ch = torch.where(o_sel2, ch[order2], n_ch)
    o_t2 = t[order2]
    o_row = torch.div(addr[order2], cfg.dram_row_div, rounding_mode="floor")
    ch_c = torch.clamp(o_ch, 0, n_ch - 1).long()

    seg2 = first.clone()
    seg2[1:] = o_ch[1:] != o_ch[:-1]
    prev_row = torch.cat([torch.full((1,), -2, dtype=torch.int32,
                                     device=dev), o_row[:-1]])
    prev_row = torch.where(seg2, mem["dram_row"][ch_c], prev_row)
    row_hit = (o_row == prev_row) & o_sel2
    service2 = torch.where(row_hit, dyn.mem.dram_burst,
                           dyn.mem.dram_burst + dyn.mem.dram_row_penalty)
    arrival2 = torch.maximum(o_t2, mem["dram_busy"][ch_c])
    finish2 = _seg_maxplus(seg2, service2, arrival2)

    resp2 = finish2 + dyn.mem.part_lat + dyn.icnt.icnt_lat
    stage = torch.where(sel2, 3, stage).int()
    t = t.scatter(0, order2, torch.where(o_sel2, resp2, o_t2).int())

    dram_busy = mem["dram_busy"].scatter_reduce(
        0, ch_c, torch.where(o_sel2, finish2, 0), "amax")
    # The reference scatters every row: the last row of each channel's
    # segment writes its row, every other row writes the OLD value of
    # channel C-1 to index C-1, and the duplicate writes apply in sorted
    # order.  So channel C-1 ends with the value of the last row (in
    # sorted order) that targets it.
    seg_last = torch.ones_like(first)
    seg_last[:-1] = o_ch[1:] != o_ch[:-1]
    last_sel = seg_last & o_sel2
    tgt = torch.where(last_sel, ch_c, n_ch - 1)
    val = torch.where(last_sel, o_row, mem["dram_row"][n_ch - 1])
    dram_row = _set_masked(mem["dram_row"], tgt, val, tgt != n_ch - 1)
    pos = torch.where(tgt == n_ch - 1, rank, -1).max().view(1)
    last_val = torch.where(pos >= 0, val.gather(0, pos.clamp(min=0).long()),
                           mem["dram_row"][n_ch - 1:])
    dram_row = torch.cat([dram_row[:-1], last_val])

    stats = dict(stats,
                 dram_req=stats["dram_req"] + o_sel2.sum(dtype=torch.int32),
                 dram_row_hit=stats["dram_row_hit"]
                 + row_hit.sum(dtype=torch.int32))

    req = dict(req, stage=stage.reshape(ns, m), t=t.reshape(ns, m))
    mem = dict(mem, l2_tag=l2_tag.reshape(mem["l2_tag"].shape),
               l2_lru=l2_lru.reshape(mem["l2_lru"].shape), l2_busy=l2_busy,
               dram_busy=dram_busy, dram_row=dram_row)
    return req, mem, stats

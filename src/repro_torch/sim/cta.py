"""CTA (thread-block) dispatch — Algorithm 1's ``issueBlocksToSMs``.

Runs at quantum boundaries in the serial region.  Blocks are dealt
breadth-first, round-robin over the ORIGINAL SM ids starting from a
rotating pointer; warp slots are filled lowest-index-first.  Takes only
the static config: dispatch depends on shape and capacity fields alone.

Lanes: the warp table is ``(L, n_sm, W)``, ``ctrl``'s counters, the
global stats and the trace's scalars ``(L,)``; each lane dispatches its
own kernel to its own SMs.
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import StaticConfig


def cta_issue(warp: dict, ctrl: dict, stats: dict, trace: dict,
              cfg: StaticConfig):
    n_lanes, ns, w = warp["active"].shape
    dev = warp["active"].device
    i32 = torch.int32
    n_instr = trace["n_instr"].reshape(n_lanes, 1, 1)
    wpc = trace["warps_per_cta"].reshape(n_lanes, 1)

    # free slots of warps that finished (pc done, no outstanding loads)
    finished = warp["active"] & (warp["pc"] >= n_instr) & \
        (warp["pending"] == 0)
    active = warp["active"] & ~finished

    free = ~active
    free_cnt = free.sum(-1, dtype=i32)                      # (L, ns)
    cap = torch.clamp(torch.div(free_cnt, wpc, rounding_mode="floor"),
                      max=cfg.max_cta_per_sm)

    # one CTA per SM per round, SMs in deal order from rr
    pos = torch.remainder(ctrl["sm_ids"] - ctrl["rr"][:, None], ns)
    perm = torch.argsort(pos, dim=-1, stable=True)
    inv_perm = torch.argsort(perm, dim=-1, stable=True)
    remaining = torch.clamp(trace["n_ctas"].reshape(n_lanes)
                            - ctrl["next_cta"], min=0)      # (L,)

    maxc = int(cfg.max_cta_per_sm)
    rounds = torch.arange(maxc, dtype=i32, device=dev)
    elig = cap[..., None] > rounds                          # (L, ns, maxc)
    # rank of each SM among this round's eligible SMs, in deal order
    in_order = elig.gather(1, perm[..., None].expand(-1, -1, maxc))
    rank = (torch.cumsum(in_order.int(), 1, dtype=i32) - 1).gather(
        1, inv_perm[..., None].expand(-1, -1, maxc))
    # The reference deals round by round, each round taking
    # min(eligible SMs, CTAs left).  By induction the CTAs dealt before
    # round r are min(remaining, eligible SMs summed over rounds < r), so
    # all rounds are dealt at once.
    n_elig = elig.sum(1, dtype=i32)                         # (L, maxc)
    before = torch.cumsum(n_elig, -1, dtype=i32) - n_elig
    assigned_before = torch.minimum(before, remaining[:, None])
    assigned = torch.minimum(n_elig.sum(-1, dtype=i32), remaining)
    take_r = elig & (rank < (remaining[:, None]
                             - assigned_before)[:, None, :])
    cta_grid = torch.where(
        take_r, ctrl["next_cta"][:, None, None]
        + assigned_before[:, None, :] + rank, -1)
    alloc = take_r.sum(-1, dtype=i32)                       # (L, ns)

    new_warps = alloc * wpc
    slot_rank = torch.cumsum(free.int(), -1, dtype=i32) - 1
    take = free & (slot_rank < new_warps[..., None])
    grid_col = torch.clamp(torch.div(slot_rank, wpc[..., None],
                                     rounding_mode="floor"),
                           0, maxc - 1).long()
    cta_of_slot = torch.gather(cta_grid, 2, grid_col)

    t0 = ctrl["cycle"].reshape(n_lanes, 1, 1)
    warp = dict(
        warp,
        active=active | take,
        pc=torch.where(take, 0, warp["pc"]),
        ready_at=torch.where(take, t0, warp["ready_at"]),
        pending=torch.where(take, 0, warp["pending"]),
        wait_mem=warp["wait_mem"] & ~take,
        wait_bar=warp["wait_bar"] & ~take,
        cta=torch.where(take, cta_of_slot, warp["cta"]),
        wic=torch.where(take, torch.remainder(slot_rank, wpc[..., None]),
                        warp["wic"]),
    )
    ctrl = dict(ctrl,
                next_cta=ctrl["next_cta"] + assigned,
                rr=torch.remainder(ctrl["rr"] + 1, ns))
    stats = dict(stats, ctas_launched=stats["ctas_launched"] + assigned)
    return warp, ctrl, stats

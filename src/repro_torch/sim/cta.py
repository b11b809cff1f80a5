"""CTA (thread-block) dispatch — Algorithm 1's ``issueBlocksToSMs``.

Runs at quantum boundaries in the serial region.  Blocks are dealt
breadth-first, round-robin over the ORIGINAL SM ids starting from a
rotating pointer; warp slots are filled lowest-index-first.  Takes only
the static config: dispatch depends on shape and capacity fields alone.
"""
from __future__ import annotations

import torch

from repro_torch.sim.config import StaticConfig


def cta_issue(warp: dict, ctrl: dict, stats: dict, trace: dict,
              cfg: StaticConfig):
    ns, w = warp["active"].shape
    dev = warp["active"].device
    i32 = torch.int32
    n_instr = trace["n_instr"]
    wpc = trace["warps_per_cta"]

    # free slots of warps that finished (pc done, no outstanding loads)
    finished = warp["active"] & (warp["pc"] >= n_instr) & \
        (warp["pending"] == 0)
    active = warp["active"] & ~finished

    free = ~active
    free_cnt = free.sum(1, dtype=i32)
    cap = torch.clamp(torch.div(free_cnt, wpc, rounding_mode="floor"),
                      max=cfg.max_cta_per_sm)

    # one CTA per SM per round, SMs in deal order from rr
    pos = torch.remainder(ctrl["sm_ids"] - ctrl["rr"], ns)
    perm = torch.argsort(pos, stable=True)
    inv_perm = torch.argsort(perm, stable=True)
    remaining = torch.clamp(trace["n_ctas"] - ctrl["next_cta"], min=0)

    maxc = int(cfg.max_cta_per_sm)
    rounds = torch.arange(maxc, dtype=i32, device=dev)
    elig = cap[:, None] > rounds                            # (ns, maxc)
    # rank of each SM among this round's eligible SMs, in deal order
    rank = (torch.cumsum(elig[perm].int(), 0, dtype=i32) - 1)[inv_perm]
    # The reference deals round by round, each round taking
    # min(eligible SMs, CTAs left).  By induction the CTAs dealt before
    # round r are min(remaining, eligible SMs summed over rounds < r), so
    # all rounds are dealt at once.
    n_elig = elig.sum(0, dtype=i32)
    before = torch.cumsum(n_elig, 0, dtype=i32) - n_elig
    assigned_before = torch.minimum(before, remaining)      # (maxc,)
    assigned = torch.minimum(n_elig.sum(dtype=i32), remaining)
    take_r = elig & (rank < remaining - assigned_before)
    cta_grid = torch.where(take_r, ctrl["next_cta"] + assigned_before + rank,
                           -1)
    alloc = take_r.sum(1, dtype=i32)

    new_warps = alloc * wpc                                 # per sm
    slot_rank = torch.cumsum(free.int(), 1, dtype=i32) - 1
    take = free & (slot_rank < new_warps[:, None])
    grid_col = torch.clamp(torch.div(slot_rank, wpc, rounding_mode="floor"),
                           0, maxc - 1).long()
    cta_of_slot = torch.gather(cta_grid, 1, grid_col)

    t0 = ctrl["cycle"]
    warp = dict(
        warp,
        active=active | take,
        pc=torch.where(take, 0, warp["pc"]),
        ready_at=torch.where(take, t0, warp["ready_at"]),
        pending=torch.where(take, 0, warp["pending"]),
        wait_mem=warp["wait_mem"] & ~take,
        wait_bar=warp["wait_bar"] & ~take,
        cta=torch.where(take, cta_of_slot, warp["cta"]),
        wic=torch.where(take, torch.remainder(slot_rank, wpc), warp["wic"]),
    )
    ctrl = dict(ctrl,
                next_cta=ctrl["next_cta"] + assigned,
                rr=torch.remainder(ctrl["rr"] + 1, ns))
    stats = dict(stats, ctas_launched=stats["ctas_launched"] + assigned)
    return warp, ctrl, stats

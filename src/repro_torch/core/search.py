"""Search-driven DSE: propose → analytic prune → cycle-accurate verify.

The port's copy of ``repro.core.search``.  Each round a seeded proposer
(uniform random + evolutionary mutation of the best verified points)
emits candidate ``DynConfig`` vectors, the analytical model
(core/analytic.py) scores them all in one vectorized product, only the
predicted-best ``search_topk`` survivors run through the engine — one
``sweep()`` call per round, on the CUDA device unless ``device`` names
another — and every measured result feeds back into the model's
least-squares calibration before the next round proposes.  Per round the
predicted-vs-measured Spearman rank correlation is reported.

Determinism: the proposer draws from ``np.random.PCG64(seed)`` only, the
engine is deterministic and bit-exact against the reference, argsorts
are stable, duplicates are dropped by ``tobytes``, elites are ordered by
(cycles, bytes), measured cycles are float64 and least squares is
``np.linalg.lstsq`` — so a search equals the reference's search of the
same seed, timings apart, on one machine.  The objective is the minimum
measured cycles over the space.

Knobs ride the RunPlan: ``search_seed`` / ``search_rounds`` /
``search_topk`` (core/plan.py); candidate volume per round is the
``n_candidates`` argument (launch/dse.py ``--search-cands``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import analytic
from repro_torch.core.analytic import (CostModel, N_PARAMS, P_DISP, P_LAT,
                                 P_SCHED, decode, encode_config)
from repro_torch.core.plan import RunPlan, resolve_plan
from repro_torch.core.sweep import sweep
from repro_torch.device import resolve_device
from repro_torch.sim import features as F
from repro_torch.sim.config import (GPUConfig, N_CLASSES, class_index,
                                    static_part)

# fraction of a round's candidates proposed by elite mutation once
# verified elites exist (the rest stay uniform-random immigrants)
MUTATE_FRACTION = 0.5
# per-dimension mutation probability
MUTATE_P = 0.35


@dataclass(frozen=True)
class SearchSpace:
    """Box bounds over the 21-dim candidate vector (analytic.PARAM_NAMES
    order); ``lo[i] == hi[i]`` freezes dimension ``i``."""
    lo: tuple
    hi: tuple

    def __post_init__(self):
        if len(self.lo) != N_PARAMS or len(self.hi) != N_PARAMS:
            raise ValueError(
                f"SearchSpace bounds must have {N_PARAMS} dims, got "
                f"({len(self.lo)}, {len(self.hi)})")
        for i, (a, b) in enumerate(zip(self.lo, self.hi)):
            if a > b:
                raise ValueError(
                    f"SearchSpace dim {i} ({analytic.PARAM_NAMES[i]}): "
                    f"lo={a} > hi={b}")

    @classmethod
    def from_base(cls, base: GPUConfig, spread: float = 2.0,
                  sample_lat=(), sample_disp=()) -> "SearchSpace":
        """Bounds around a base config: every scalar/table entry spans
        [v/spread, v·spread] (integer, ≥ 1 where the engine needs it);
        ``icnt_lat`` is floored at the machine quantum (the Δ ≤ icnt_lat
        exactness invariant, sim/config.py:check_dyn); the inert-by-
        construction zero table entries (lat[ldg]/lat[stg]) stay frozen.
        ``sample_lat``/``sample_disp`` (CLASS, LO, HI) triples — the same
        wire format as the launchers' ``--sample-*`` flags — override the
        corresponding table dimension's bounds."""
        vec = encode_config(base)
        lo, hi = list(map(int, vec)), list(map(int, vec))

        def span(v, floor=1):
            if v <= 0:
                return v, v                 # frozen (inert entries)
            return max(floor, int(round(v / spread))), \
                max(floor, int(round(v * spread)))

        for i in range(len(analytic.P_SCALARS)):
            lo[i], hi[i] = span(int(vec[i]))
        lo[P_SCHED], hi[P_SCHED] = 0, 1
        for c in range(N_CLASSES):
            lo[P_LAT + c], hi[P_LAT + c] = span(int(vec[P_LAT + c]))
            lo[P_DISP + c], hi[P_DISP + c] = span(int(vec[P_DISP + c]))
        icnt_i = analytic.P_SCALARS.index("icnt_lat")
        lo[icnt_i] = max(lo[icnt_i], base.quantum)
        hi[icnt_i] = max(hi[icnt_i], lo[icnt_i])
        for table_base, triples in ((P_LAT, sample_lat),
                                    (P_DISP, sample_disp)):
            for cname, a, b in triples:
                i = table_base + class_index(str(cname))
                lo[i], hi[i] = int(a), int(b)
        return cls(lo=tuple(lo), hi=tuple(hi))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """n uniform candidates, (n, N_PARAMS) int64."""
        lo = np.asarray(self.lo, np.int64)
        hi = np.asarray(self.hi, np.int64)
        return rng.integers(lo, hi + 1, size=(n, N_PARAMS))

    def mutate(self, rng: np.random.Generator, parents: np.ndarray,
               n: int) -> np.ndarray:
        """n children: each picks a random parent and perturbs each free
        dimension with prob MUTATE_P by a step ∝ the dimension's range."""
        lo = np.asarray(self.lo, np.int64)
        hi = np.asarray(self.hi, np.int64)
        step = np.maximum((hi - lo) // 8, 1)
        picks = parents[rng.integers(len(parents), size=n)]
        flip = rng.random((n, N_PARAMS)) < MUTATE_P
        delta = rng.integers(-step, step + 1, size=(n, N_PARAMS))
        out = np.where(flip, picks + delta, picks)
        return np.clip(out, lo, hi)


@dataclass
class SearchResult:
    scfg: object
    space: SearchSpace
    seed: int
    features: np.ndarray              # the workload's feature vector
    best: dict                        # flat override dict of the winner
    best_cycles: int
    best_stats: dict                  # finalized stats of the winner
    model: CostModel                  # final calibrated surrogate
    rounds: list = field(default_factory=list)   # per-round reports
    verified: list = field(default_factory=list)  # [(vec, cycles, stats)]

    @property
    def n_scored(self) -> int:
        return sum(r["n_scored"] for r in self.rounds)

    @property
    def n_verified(self) -> int:
        return len(self.verified)

    def report(self) -> dict:
        """JSON-safe summary for manifests / the launcher."""
        return {
            "seed": self.seed,
            "best": analytic.describe_vec(
                analytic.encode(self.best)),
            "best_cycles": int(self.best_cycles),
            "n_scored": self.n_scored,
            "n_verified": self.n_verified,
            "calibration": self.model.calib,
            "rounds": self.rounds,
        }


def _dedupe(cands: np.ndarray) -> np.ndarray:
    """Drop duplicate candidate rows, keeping first occurrence (stable —
    part of the per-seed determinism contract)."""
    seen, keep = set(), []
    for i, row in enumerate(cands):
        key = row.tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return cands[keep]


def search(workload, space: SearchSpace = None, plan: RunPlan = None,
           seed: int = None, base: GPUConfig = None,
           n_candidates: int = 256, calibrate_from: str | None = None,
           log=None, device=None) -> SearchResult:
    """Seeded analytic-prune search for the config minimizing measured
    cycles on ``workload``.

    Per round: propose ``n_candidates`` (uniform random, plus elite
    mutations once measured elites exist) → score ALL of them with the
    analytical surrogate in one vectorized call → verify the predicted
    top ``plan.search_topk`` in ONE cycle-accurate ``sweep()`` →
    recalibrate the surrogate on every measured row so far → report the
    round's predicted-vs-measured rank correlation.

    ``calibrate_from``: a run-manifest directory to warm-start the
    surrogate from (rows recorded by previous search runs of the same
    StaticConfig); None starts from the uncalibrated prior — what the
    determinism tests use, since reading manifests would couple runs.
    ``device``: where the verify sweeps run (default: the CUDA card).
    """
    plan = resolve_plan(plan, where="search")
    if seed is None:
        seed = plan.search_seed
    base = base or GPUConfig()
    if space is None:
        space = SearchSpace.from_base(base)
    device = resolve_device(device)
    scfg = static_part(base)
    feats = F.workload_features(workload, scfg)
    rng = np.random.Generator(np.random.PCG64(seed))

    rows = []
    if calibrate_from is not None:
        rows = analytic.calibration_rows_from_manifests(
            scfg, calibrate_from if calibrate_from != "" else None)
    model = CostModel.fit(rows, source="manifests") if rows \
        else CostModel.default()

    topk = min(plan.search_topk, n_candidates)
    verified = []                 # (vec, cycles, stats), every round
    seen_keys = set()
    rounds = []
    for rnd in range(plan.search_rounds):
        if verified:
            n_mut = int(n_candidates * MUTATE_FRACTION)
            elites = np.stack([v for v, _, _ in sorted(
                verified, key=lambda t: (t[1], t[0].tobytes()))[:topk]])
            cands = np.concatenate([
                space.mutate(rng, elites, n_mut),
                space.sample(rng, n_candidates - n_mut)])
        else:
            cands = space.sample(rng, n_candidates)
        cands = _dedupe(cands)

        t0 = time.perf_counter()
        scores = model.predict(feats, cands)
        analytic_s = time.perf_counter() - t0
        order = np.argsort(scores, kind="stable")

        # verify the top-k UNSEEN candidates (re-verifying a lane already
        # measured would waste the round's one sweep call)
        top_idx = [int(i) for i in order
                   if cands[i].tobytes() not in seen_keys][:topk]
        if not top_idx:           # space exhausted (tiny/frozen spaces)
            break
        top = cands[top_idx]
        for v in top:
            seen_keys.add(v.tobytes())
        lanes = [(scfg, decode(v)) for v in top]
        res = sweep(workload, lanes, plan=plan, device=device)
        measured = np.asarray(res.cycles, np.float64)
        corr = analytic.spearman(scores[top_idx], measured)

        for v, c, st in zip(top, measured, res.stats):
            verified.append((v, float(c), st))
            rows.append((feats, v, float(c)))
        model = CostModel.fit(rows)

        best_i = int(np.argmin(measured))
        rounds.append({
            "round": rnd,
            "n_scored": int(len(cands)),
            "n_verified": int(len(top)),
            "analytic_s": round(analytic_s, 6),
            "analytic_cands_per_s": round(
                len(cands) / max(analytic_s, 1e-9), 1),
            "verify_s": res.timings.get("execute_s"),
            "verify_lanes_per_s": res.timings.get("lanes_per_s"),
            "rank_corr": None if corr is None else round(corr, 4),
            "best_measured": int(measured[best_i]),
            "best_predicted": round(float(scores[top_idx[best_i]]), 1),
            "calibration": model.calib,
        })
        if log:
            log(f"[search] round {rnd}: scored {len(cands)} "
                f"({rounds[-1]['analytic_cands_per_s']}/s analytic), "
                f"verified {len(top)}, rank_corr={rounds[-1]['rank_corr']}"
                f", best={int(measured[best_i])} cycles")

    best_vec, best_cycles, best_stats = min(
        verified, key=lambda t: (t[1], t[0].tobytes()))
    return SearchResult(
        scfg=scfg, space=space, seed=seed, features=feats,
        best=decode(best_vec), best_cycles=int(best_cycles),
        best_stats=best_stats, model=model, rounds=rounds,
        verified=[(v, int(c), st) for v, c, st in verified])

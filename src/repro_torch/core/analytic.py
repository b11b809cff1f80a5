"""Analytical fast-path cost model — score configs without simulating.

The port's copy of ``repro.core.analytic`` (pure numpy).  A candidate
config is priced by a basis that is linear in fitted coefficients θ,
built from the workload's instruction-mix features (sim/features.py) and
the candidate's timing parameters: issue throughput (Σ issue[c]·disp[c]),
the dependency latency chain (Σ chain[c]·lat[c]), per-address-mode memory
round trips (L1 hit, L2 trip, DRAM trip), a DRAM bandwidth term and
per-wave overhead.  θ is self-calibrated against the cycle-accurate
engine's own results by one least-squares solve: rows harvested from run
manifests under ``experiments/runs/`` (``calibration_rows_from_manifests``,
which reads the reference's manifests as well as the port's) or the
verify sweeps of a running search (core/search.py).  Scoring a candidate
batch is one (n × N_BASIS) @ (N_BASIS,) product.

Candidate encoding: one flat int vector of the 21 dynamic parameters
(6 scalars + sched + lat[7] + disp[7], ``N_PARAMS``), shared with
core/search.py's proposers; ``decode`` turns a vector into the flat
override dict that ``core/sweep.py:stack_dyn`` accepts.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch.sim import features as F
from repro_torch.sim.config import (DYNAMIC_FIELDS, LDG, N_CLASSES,
                                    SCHEDULERS, static_part)

# ---------------------------------------------------------------------------
# candidate parameter vectors
# ---------------------------------------------------------------------------

# vector layout: the 6 scalar timing fields, the scheduler selector, then
# the two (N_CLASSES,) tables
P_SCALARS = DYNAMIC_FIELDS                  # indices [0, 6)
P_SCHED = len(P_SCALARS)                    # 6
P_LAT = P_SCHED + 1                         # [7, 14)
P_DISP = P_LAT + N_CLASSES                  # [14, 21)
N_PARAMS = P_DISP + N_CLASSES

PARAM_NAMES = tuple(
    list(P_SCALARS) + ["sched"]
    + [f"lat_{c}" for c in range(N_CLASSES)]
    + [f"disp_{c}" for c in range(N_CLASSES)])

_SCHED_NAMES = {v: k for k, v in SCHEDULERS.items()}


def encode(flat: dict) -> np.ndarray:
    """Flat override dict (DYN_KEYS complete, sim/config.py) → (N_PARAMS,)
    int64 vector."""
    v = np.zeros(N_PARAMS, np.int64)
    for i, k in enumerate(P_SCALARS):
        v[i] = int(flat[k])
    v[P_SCHED] = int(flat["sched"])
    v[P_LAT:P_LAT + N_CLASSES] = np.asarray(flat["lat"], np.int64)
    v[P_DISP:P_DISP + N_CLASSES] = np.asarray(flat["disp"], np.int64)
    return v


def encode_config(cfg) -> np.ndarray:
    """GPUConfig → (N_PARAMS,) vector (via its dynamic fields)."""
    flat = {k: getattr(cfg, k) for k in P_SCALARS}
    flat["sched"] = SCHEDULERS[cfg.scheduler]
    flat["lat"] = cfg.lat_of_class
    flat["disp"] = cfg.disp_of_class
    return encode(flat)


def decode(vec) -> dict:
    """(N_PARAMS,) vector → the flat override dict ``stack_dyn`` accepts
    as a ``(StaticConfig, overrides)`` lane."""
    vec = np.asarray(vec)
    d = {k: int(vec[i]) for i, k in enumerate(P_SCALARS)}
    d["sched"] = int(vec[P_SCHED])
    d["lat"] = tuple(int(x) for x in vec[P_LAT:P_LAT + N_CLASSES])
    d["disp"] = tuple(int(x) for x in vec[P_DISP:P_DISP + N_CLASSES])
    return d


def describe_vec(vec) -> dict:
    """Manifest-friendly lane description of a candidate vector — same
    key layout as launch/dse.py:describe so calibration can read both."""
    d = decode(vec)
    sched = d.pop("sched")
    d["scheduler"] = _SCHED_NAMES.get(sched, str(sched))
    d["lat"] = list(d["lat"])
    d["disp"] = list(d["disp"])
    return d


def params_from_lane(lane: dict) -> np.ndarray | None:
    """Parse a manifest lane description (launch/dse.py:describe format)
    back into a parameter vector; None if keys are missing/garbled."""
    try:
        flat = {k: int(lane[k]) for k in P_SCALARS}
        sched = lane.get("sched")
        if sched is None:
            sched = SCHEDULERS[str(lane["scheduler"]).lower()]
        flat["sched"] = int(sched)
        flat["lat"] = [int(x) for x in lane["lat"]]
        flat["disp"] = [int(x) for x in lane["disp"]]
        if len(flat["lat"]) != N_CLASSES or len(flat["disp"]) != N_CLASSES:
            return None
        return encode(flat)
    except (KeyError, TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# basis
# ---------------------------------------------------------------------------

BASIS_NAMES = ("const", "throughput", "lat_chain", "l1_trip",
               "l2_trip_stream", "l2_trip_strided", "l2_trip_random",
               "dram_trip_strided", "dram_trip_random", "dram_bw",
               "waves", "sched_scale")
N_BASIS = len(BASIS_NAMES)


def basis_matrix(feats: np.ndarray, params: np.ndarray) -> np.ndarray:
    """(n, N_BASIS) basis for one workload's features × n candidate
    vectors.  Vectorized over candidates: the analytic scoring hot path.
    """
    params = np.atleast_2d(np.asarray(params, np.float64))
    n = params.shape[0]
    scal = params[:, :P_SCHED]
    l1, l2, part, burst, rowpen, icnt = (scal[:, i] for i in range(6))
    sched = params[:, P_SCHED]
    lat = params[:, P_LAT:P_LAT + N_CLASSES]
    disp = params[:, P_DISP:P_DISP + N_CLASSES]

    issue = feats[F.F_ISSUE:F.F_ISSUE + N_CLASSES]
    chain = feats[F.F_CHAIN:F.F_CHAIN + N_CLASSES].copy()
    chain[LDG] = 0.0                       # LDG's lat entry is inert
    dep_s, dep_t, dep_r = feats[F.F_DEP_LOAD:F.F_DEP_LOAD + F.N_MODES]
    mem_ch = feats[F.F_MEM_CH:F.F_MEM_CH + F.N_MODES].sum()

    l2_trip = l2 + 2.0 * icnt
    dram_trip = part + burst + rowpen
    cols = np.empty((n, N_BASIS), np.float64)
    cols[:, 0] = 1.0
    cols[:, 1] = disp @ issue
    cols[:, 2] = lat @ chain
    cols[:, 3] = (dep_s + dep_t + dep_r) * l1
    cols[:, 4] = dep_s * l2_trip
    cols[:, 5] = dep_t * l2_trip
    cols[:, 6] = dep_r * l2_trip
    cols[:, 7] = dep_t * dram_trip
    cols[:, 8] = dep_r * dram_trip
    cols[:, 9] = mem_ch * burst
    cols[:, 10] = feats[F.F_WAVES]
    cols[:, 11] = feats[F.F_INSTR_SM] * sched
    return cols


# uncalibrated prior: every physical bound contributes once, with the
# random-pattern memory trips assumed mostly missing and the streaming
# ones mostly hitting — good enough to rank candidates before the first
# measured batch arrives (and for the auto-bucket cost keys)
DEFAULT_THETA = np.array(
    [0.0, 1.0, 1.0, 1.0, 0.1, 0.5, 1.0, 0.5, 1.0, 1.0, 0.0, 0.0],
    np.float64)


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks (scipy-free)."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def spearman(a, b) -> float | None:
    """Spearman rank correlation; None when either side is constant
    (correlation undefined)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if len(a) < 2:
        return None
    ra, rb = _rankdata(a), _rankdata(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return None
    return float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / (sa * sb))


# ---------------------------------------------------------------------------
# the calibrated model
# ---------------------------------------------------------------------------

@dataclass
class CostModel:
    """θ over the basis terms + a calibration report.

    ``predict(feats, params)`` scores a candidate batch in one matmul;
    ``fit(rows)`` least-squares-solves θ from measured (features, params,
    cycles) rows and reports in-sample relative error and rank
    correlation — the self-calibration loop's health signals."""
    theta: np.ndarray = field(default_factory=lambda: DEFAULT_THETA.copy())
    calib: dict = field(default_factory=lambda: {"source": "default",
                                                "n_rows": 0})

    def predict(self, feats: np.ndarray, params) -> np.ndarray:
        return basis_matrix(feats, params) @ self.theta

    def predict_one(self, feats: np.ndarray, params_vec) -> float:
        return float(self.predict(feats, np.atleast_2d(params_vec))[0])

    @classmethod
    def default(cls) -> "CostModel":
        return cls()

    @classmethod
    def fit(cls, rows, source: str = "measured") -> "CostModel":
        """Least-squares θ from measured rows: each row is
        (feature_vector, param_vector, measured_cycles).  Falls back to
        the default prior when rows are empty."""
        if not rows:
            return cls.default()
        phi = np.vstack([basis_matrix(f, np.atleast_2d(p))
                         for f, p, _ in rows])
        y = np.asarray([float(c) for _, _, c in rows], np.float64)
        theta, *_ = np.linalg.lstsq(phi, y, rcond=None)
        pred = phi @ theta
        denom = np.maximum(np.abs(y), 1.0)
        rel = np.abs(pred - y) / denom
        calib = {
            "source": source,
            "n_rows": len(rows),
            "mean_rel_err": round(float(rel.mean()), 4),
            "max_rel_err": round(float(rel.max()), 4),
            "rank_corr": spearman(pred, y),
        }
        return cls(theta=np.asarray(theta, np.float64), calib=calib)


# ---------------------------------------------------------------------------
# calibration rows from run manifests
# ---------------------------------------------------------------------------

def calibration_rows_from_manifests(scfg, run_dir: str | None = None) -> list:
    """Harvest (features, params, measured_cycles) calibration rows from
    prior run manifests under ``experiments/runs/``.

    Only manifests that (a) recorded the workload's feature vector
    (search runs write one — core/search.py via launch/dse.py) and
    (b) match this StaticConfig's hash (timing rows from a different
    machine shape would poison the fit) contribute.  Garbled manifests
    are skipped: calibration data is an optimization, never a
    correctness input."""
    from repro_torch.core.telemetry import runs_dir, static_hash

    scfg = static_part(scfg)
    want = static_hash(scfg)
    run_dir = run_dir or runs_dir()
    rows = []
    for path in sorted(glob.glob(os.path.join(run_dir, "*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if payload.get("static_config_hash") != want:
            continue
        feats = payload.get("features")
        lanes = payload.get("lanes")
        stats = payload.get("stats")
        if not (isinstance(feats, list) and lanes and stats
                and len(lanes) == len(stats)):
            continue
        feats = np.asarray(feats, np.float64)
        if feats.shape != (F.N_FEATURES,):
            continue
        for lane, stat in zip(lanes, stats):
            if not (isinstance(lane, dict) and isinstance(stat, dict)):
                continue
            vec = params_from_lane(lane)
            try:
                cycles = float(stat["cycles"])
            except (KeyError, TypeError, ValueError):
                continue
            if vec is not None:
                rows.append((feats, vec, cycles))
    return rows


# ---------------------------------------------------------------------------
# predicted workload cost (auto bucket counts, core/batch.py)
# ---------------------------------------------------------------------------

def predicted_workload_cost(workload, scfg, params_vec=None,
                            model: CostModel | None = None) -> float:
    """Model-predicted cycles of one workload under one parameter point —
    the cost key ``core/batch.py`` uses to pick bucket counts when
    ``bucket_by='cost'`` and ``max_buckets`` is unset.  Defaults to the
    uncalibrated prior and the engine's default timing tables."""
    scfg = static_part(scfg)
    if params_vec is None:
        from repro_torch.sim.config import GPUConfig
        params_vec = encode_config(GPUConfig())
    model = model or CostModel.default()
    feats = F.workload_features(workload, scfg)
    return max(model.predict_one(feats, params_vec), 0.0)

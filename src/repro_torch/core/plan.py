"""RunPlan — the one typed home for every execution knob of a run.

The port's copy of ``repro.core.plan``: the same fields, defaults,
validation and messages, threaded through ``sweep`` / ``grid_sweep`` /
``pair_sweep`` / ``simulate`` and both launchers (via launch/cli.py).

Fields by concern:

  execution   ``mode`` (seq/vmap), ``max_cycles`` (per-kernel quantum-loop
              horizon), ``early_exit`` (entry-converged lanes charge zero
              quanta — core/engine.py); ``mesh`` + ``exchange`` (2-D
              ('cfg','sm') distribution, core/distribute.py).
  packing     ``bucket_by`` ('none' | 'shape' | 'cost'): split the
              workload lanes of a grid into ≤ ``max_buckets`` buckets of
              similar padded shape / predicted cost and run each bucket
              padded only to its own max (core/batch.py:bucket_workloads).
              ``layout`` ('padded' | 'ragged'): per-bucket trace layout.
  telemetry   ``telemetry_samples`` / ``telemetry_every`` — applied to
              the lanes' StaticConfig (all-lanes-or-none) by
              ``apply_telemetry``.
  caching     ``cache_dir`` (a persistent cache of compiled programs: the
              port compiles no program, and it waits for a graph cache);
              ``aot_cache`` is accepted and inert — the port runs eagerly,
              so there is no compiled executable to keep.

What the port cannot do yet (``cache_dir``) raises
``NotImplementedError`` after the reference's own validation.

Legacy keyword compatibility: ``resolve_plan`` lets the old flat kwargs
(`mode=`, `max_cycles=`, `mesh=`, `exchange=`) build a RunPlan and warn
once (DeprecationWarning), as the reference does.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

MODES = ("seq", "vmap")
EXCHANGES = ("window", "cycle")
BUCKET_POLICIES = ("none", "shape", "cost")
LAYOUTS = ("padded", "ragged")


@dataclass(frozen=True)
class RunPlan:
    """Every execution knob of a ``sweep``/``grid_sweep``/``pair_sweep``/
    ``simulate`` call, validated once at construction."""
    # execution
    mode: str = "vmap"
    mesh: object = None          # core/distribute.py:Mesh, ('cfg','sm') axes
    exchange: str = "window"
    max_cycles: int = 1 << 20
    early_exit: bool = True
    # packing.  max_buckets=None with bucket_by='cost' picks the bucket
    # count by minimizing the analytically-predicted total padded cost
    # (core/batch.py:choose_bucket_count); with other policies None falls
    # back to the classic ceiling of 4.
    bucket_by: str = "none"
    max_buckets: int | None = 4
    layout: str = "padded"
    # telemetry (sized into the lanes' StaticConfig — all lanes or none)
    telemetry_samples: int = 0
    telemetry_every: int = 1
    # caching: cache_dir waits for a graph cache; aot_cache is inert
    cache_dir: str | None = None
    aot_cache: bool = True
    # analytic-prune search (core/search.py): proposer seed, rounds of
    # propose→score→verify, and how many predicted-best candidates each
    # round's one cycle-accurate sweep verifies
    search_seed: int = 0
    search_rounds: int = 3
    search_topk: int = 8

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"RunPlan.mode must be one of {MODES}, got {self.mode!r} "
                "(SM-axis 'shard' execution is reached via mesh=, not "
                "mode=)")
        if self.exchange not in EXCHANGES:
            raise ValueError(
                f"RunPlan.exchange must be one of {EXCHANGES}, got "
                f"{self.exchange!r}")
        if self.bucket_by not in BUCKET_POLICIES:
            raise ValueError(
                f"RunPlan.bucket_by must be one of {BUCKET_POLICIES}, got "
                f"{self.bucket_by!r}")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"RunPlan.layout must be one of {LAYOUTS}, got "
                f"{self.layout!r}")
        if self.max_cycles <= 0:
            raise ValueError(
                f"RunPlan.max_cycles must be positive, got "
                f"{self.max_cycles}")
        if self.max_buckets is not None and self.max_buckets < 1:
            raise ValueError(
                f"RunPlan.max_buckets must be ≥ 1 (or None for the "
                f"cost-model-driven automatic count), got "
                f"{self.max_buckets}")
        if self.search_seed < 0:
            raise ValueError(
                f"RunPlan.search_seed must be ≥ 0, got {self.search_seed}")
        if self.search_rounds < 1:
            raise ValueError(
                f"RunPlan.search_rounds must be ≥ 1, got "
                f"{self.search_rounds}")
        if self.search_topk < 1:
            raise ValueError(
                f"RunPlan.search_topk must be ≥ 1, got {self.search_topk}")
        if self.telemetry_samples < 0:
            raise ValueError(
                f"RunPlan.telemetry_samples must be ≥ 0, got "
                f"{self.telemetry_samples}")
        if self.telemetry_every < 1:
            raise ValueError(
                f"RunPlan.telemetry_every must be ≥ 1, got "
                f"{self.telemetry_every}")
        if self.mesh is not None:
            if self.mode != "vmap":
                raise ValueError(
                    f"RunPlan.mode={self.mode!r} conflicts with mesh=: the "
                    "distributed path has its own in-lane execution "
                    "(sharded SM axis); use mode='vmap' (the default) or "
                    "drop mesh=")
            names = tuple(getattr(self.mesh, "axis_names", ()))
            if "cfg" not in names or "sm" not in names:
                raise ValueError(
                    "RunPlan.mesh must be a 2-D ('cfg','sm') mesh "
                    f"(core/distribute.py:make_mesh), got axes {names}")
        # what the port does not run yet
        if self.cache_dir:
            raise NotImplementedError(
                f"RunPlan.cache_dir={self.cache_dir!r}: the port compiles "
                "no program to cache; a persistent cache waits for the "
                "graph cache of the quantum step")

    def apply_telemetry(self, cfgs):
        """Size the counter-timeline buffer into every lane's static half
        (no-op when ``telemetry_samples == 0``).  Lanes may be full
        GPUConfig / StaticConfig objects or pre-split ``(StaticConfig,
        overrides)`` pairs — all of them must share one StaticConfig, so
        telemetry is all-lanes-or-none."""
        if self.telemetry_samples <= 0:
            return cfgs
        kw = dict(telemetry_samples=self.telemetry_samples,
                  telemetry_every=self.telemetry_every)

        def one(c):
            if isinstance(c, tuple) and len(c) == 2:
                return (dataclasses.replace(c[0], **kw), c[1])
            return dataclasses.replace(c, **kw)

        if isinstance(cfgs, (list, tuple)):
            return [one(c) for c in cfgs]
        return one(cfgs)

    def describe(self) -> dict:
        """JSON-safe summary for run manifests."""
        mesh = None
        if self.mesh is not None:
            mesh = [int(self.mesh.shape["cfg"]), int(self.mesh.shape["sm"])]
        return {
            "mode": self.mode, "mesh": mesh, "exchange": self.exchange,
            "max_cycles": self.max_cycles, "early_exit": self.early_exit,
            "bucket_by": self.bucket_by, "max_buckets": self.max_buckets,
            "layout": self.layout,
            "telemetry_samples": self.telemetry_samples,
            "telemetry_every": self.telemetry_every,
            "cache_dir": self.cache_dir, "aot_cache": self.aot_cache,
            "search_seed": self.search_seed,
            "search_rounds": self.search_rounds,
            "search_topk": self.search_topk,
        }


# ---------------------------------------------------------------------------
# legacy flat-kwarg shim (warn once)
# ---------------------------------------------------------------------------

_warned_legacy = False


def _warn_legacy_once(where: str) -> None:
    global _warned_legacy
    if not _warned_legacy:
        _warned_legacy = True
        warnings.warn(
            f"{where} received legacy flat keyword(s) (mode=/max_cycles=/"
            "mesh=/exchange=); pass plan=RunPlan(...) instead — the flat "
            "kwargs build a RunPlan for you now and will be removed next "
            "release.", DeprecationWarning, stacklevel=4)


def resolve_plan(plan, *, where: str = "sweep", mode=None, max_cycles=None,
                 mesh=None, exchange=None) -> RunPlan:
    """The one entry point ``sweep``/``grid_sweep``/``pair_sweep`` funnel
    their arguments through.

    ``plan`` given → legacy kwargs must be absent.  ``plan`` absent → any
    legacy kwargs build one (warn once); a bare string in the plan slot is
    tolerated as the old positional ``mode``."""
    if isinstance(plan, str):          # old positional: sweep(w, cfgs, "seq")
        if mode is not None:
            raise ValueError(f"{where}: mode given twice ({plan!r} and "
                             f"{mode!r})")
        plan, mode = None, plan
    legacy = {k: v for k, v in (("mode", mode), ("max_cycles", max_cycles),
                                ("mesh", mesh), ("exchange", exchange))
              if v is not None}
    if plan is not None:
        if legacy:
            raise ValueError(
                f"{where}: pass either plan= or the legacy flat kwargs "
                f"({sorted(legacy)}), not both — every knob lives on the "
                "RunPlan now")
        if not isinstance(plan, RunPlan):
            raise TypeError(
                f"{where}: plan must be a RunPlan, got {type(plan).__name__}")
        return plan
    if legacy:
        _warn_legacy_once(where)
    return RunPlan(**legacy)

"""Simulation as a service: continuous batching of sim jobs, one warm process.

The port's counterpart of ``repro.core.service``.  Clients submit *jobs*
— a zoo/``trace:<x>`` workload name or an uploaded SASS trace text, plus
a config-override lane or a ``--sample-*`` style grid — and ONE
persistent process packs every pending job into pair lanes
(core/sweep.py:pair_sweep), so unrelated submissions share one lockstep
run per bucket: on the card, one ``sm_quantum`` launch per quantum for
every lane of the bucket.

Pipeline per batch (the scheduler thread, ``_worker``):

  admit    ``build_job`` validates every field by NAME (``ServiceError``,
           mirroring sim/traceio.py:TraceFormatError), resolves the
           workload, rejects oversized CTAs via
           core/batch.py:check_workload_fits, and rejects overrides that
           would change the server's one StaticConfig shape.  Admission
           is host-side: no tensor is made before the batch runs.
  form     pending jobs accumulate until ``batch_lanes`` lanes are
           waiting, the oldest job has waited ``max_wait_s``, or a client
           flushes — then the ENTIRE queue drains into one batch (FIFO,
           so no job can starve: every formation takes everything).
  pack     the batch's (workload, cfg) lanes run through ``pair_sweep``
           on the server's device: same-footprint jobs grouped by
           bucket_workloads(plan.bucket_by) share one lockstep run, and
           ``lane_quantum`` rounds each bucket's lane count up by
           repeating LIVE lanes — padded slots carry real requests, not
           inert NOPs.
  route    per-job results stream back as each batch completes: the
           ``comparable()`` stats per lane, a queue/execute latency split,
           and (opt-in) a per-job run-manifest pointer
           (core/telemetry.py:write_job_manifest).

The port compiles no program, so a batch reports ``compile_s`` and
``aot_cache`` None, and ``aot_hits`` stays 0 (the reference reports
compile times and warm hits of its AOT executable cache).

Determinism contract (tests/test_torch_service.py): every served lane is
bit-identical to a solo ``simulate(workload, cfg)`` run regardless of
which jobs it was co-batched with, arrival order, or batch boundaries.

The server core is transport-free; launch/serve.py wires it to a
line-JSON protocol over stdin or a TCP socket.  ``start=False`` gives
tests a synchronous server: ``run_pending()`` forms exactly one batch, so
batch boundaries are test-controlled.  With ``start=True`` every batch
runs on the ``sim-service`` thread, its tensors with it; runs by other
threads on the same device wait for ``drain()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field

from repro_torch.core import stats as S
from repro_torch.core.plan import RunPlan
from repro_torch.core.sweep import pair_sweep
from repro_torch.device import resolve_device
from repro_torch.sim.config import (DYNAMIC_FIELDS, N_CLASSES, SCHEDULERS,
                                    TINY, GPUConfig, static_part)

# override keys a job's config lane may carry (all dynamic — the server
# runs ONE StaticConfig shape, so shape knobs are not accepted)
CONFIG_KEYS = DYNAMIC_FIELDS + ("scheduler", "lat_of_class", "disp_of_class")


class ServiceError(ValueError):
    """Malformed or inadmissible submission; names the offending field
    (the serving analogue of sim/traceio.py:TraceFormatError)."""

    def __init__(self, msg: str, fieldname: str | None = None):
        self.field = fieldname
        where = f"field {fieldname!r}: " if fieldname else ""
        super().__init__(f"{where}{msg}")


@dataclass
class Job:
    """One admitted submission: ≥1 (workload, cfg) pair lanes plus the
    bookkeeping the result router fills in."""
    seq: int                       # server-assigned job number
    id: str                        # client id (defaults to "job-<seq>")
    name: str                      # workload name
    pairs: list                    # [(Workload, GPUConfig), ...] lanes
    submitted_t: float = 0.0
    started_t: float = 0.0
    done_t: float = 0.0
    stats: list = None             # per-lane finalized stat dicts
    batch: dict = None             # batch-level timings / packing info
    manifest: str | None = None
    error: str | None = None
    _event: threading.Event = field(default_factory=threading.Event)

    @property
    def n_lanes(self) -> int:
        return len(self.pairs)

    def wait(self, timeout: float = None) -> bool:
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def latency(self) -> dict:
        """The queue/compile/execute split the per-job manifests record:
        how long the job sat in the queue, its batch's compile and
        execute walls (shared across the batch's jobs; the port compiles
        nothing, so ``compile_s`` is None), and end-to-end total."""
        batch = self.batch or {}
        return {
            "queue_s": round(max(self.started_t - self.submitted_t, 0.0), 4),
            "compile_s": batch.get("compile_s"),
            "execute_s": batch.get("execute_s"),
            "total_s": round(max(self.done_t - self.submitted_t, 0.0), 4),
        }

    def response(self) -> dict:
        """The JSON-safe completion payload the protocol streams back."""
        if self.error is not None:
            return {"ok": False, "id": self.id, "job": self.seq,
                    "status": "error", "error": self.error}
        return {
            "ok": True, "id": self.id, "job": self.seq, "status": "done",
            "workload": self.name, "lanes": self.n_lanes,
            "stats": [S.comparable(s) for s in self.stats],
            "latency": self.latency(),
            "batch": self.batch,
            "manifest": self.manifest,
        }


# ---------------------------------------------------------------------------
# submission parsing / admission
# ---------------------------------------------------------------------------

def _as_int(val, fieldname: str) -> int:
    if isinstance(val, bool) or not isinstance(val, (int, float)) \
            or int(val) != val:
        raise ServiceError(f"expected an integer, got {val!r}", fieldname)
    return int(val)


def apply_overrides(base: GPUConfig, overrides: dict,
                    fieldname: str = "config") -> GPUConfig:
    """One config lane from a client override dict.  Only dynamic knobs
    are accepted (the server serves ONE StaticConfig shape); unknown
    keys, bad scheduler names and bad table lengths are rejected by
    name."""
    if not isinstance(overrides, dict):
        raise ServiceError(
            f"expected an object of config overrides, got "
            f"{type(overrides).__name__}", fieldname)
    kw = {}
    for key, val in overrides.items():
        where = f"{fieldname}.{key}"
        if key == "scheduler":
            if val not in SCHEDULERS:
                raise ServiceError(
                    f"unknown scheduler {val!r}; use one of "
                    f"{sorted(SCHEDULERS)}", where)
            kw[key] = val
        elif key in ("lat_of_class", "disp_of_class"):
            if not isinstance(val, (list, tuple)) or len(val) != N_CLASSES:
                raise ServiceError(
                    f"per-class table must have {N_CLASSES} entries",
                    where)
            kw[key] = tuple(_as_int(v, where) for v in val)
        elif key in DYNAMIC_FIELDS:
            kw[key] = _as_int(val, where)
        else:
            raise ServiceError(
                f"unknown config override {key!r}; dynamic knobs are "
                f"{sorted(CONFIG_KEYS)} (shape knobs are fixed per "
                "server)", where)
    try:
        cfg = dataclasses.replace(base, **kw)
    except (ValueError, AssertionError) as e:
        raise ServiceError(str(e), fieldname) from None
    return cfg


def _sample_cfgs(base: GPUConfig, spec: dict) -> list:
    """A ``--sample-*`` style config grid from a job's ``sample`` field:
    ``{"n": N, "lat": [[class, lo, hi], ...], "disp": [...],
    "seed": S?}`` → N lanes stepping (or seeded-sampling) the named
    per-class table entries (launch/dse.py:sample_table_grid)."""
    from repro_torch.launch.dse import sample_table_grid

    if not isinstance(spec, dict):
        raise ServiceError("expected an object like "
                           '{"n": 4, "lat": [["fp32", 2, 8]]}', "sample")
    unknown = set(spec) - {"n", "lat", "disp", "seed"}
    if unknown:
        raise ServiceError(f"unknown sample key(s) {sorted(unknown)}",
                           "sample")
    n = _as_int(spec.get("n", 4), "sample.n")
    if n < 1:
        raise ServiceError(f"lane count must be ≥ 1, got {n}", "sample.n")
    for part in ("lat", "disp"):
        triples = spec.get(part, [])
        if not isinstance(triples, list) or any(
                not isinstance(t, (list, tuple)) or len(t) != 3
                for t in triples):
            raise ServiceError("expected [class, lo, hi] triples",
                               f"sample.{part}")
    seed = spec.get("seed")
    if seed is not None:
        seed = _as_int(seed, "sample.seed")
    try:
        return sample_table_grid(base, n, spec.get("lat", []),
                                 spec.get("disp", []), seed=seed)
    except (KeyError, ValueError) as e:
        raise ServiceError(str(e), "sample") from None


def _workload_from_trace_text(text: str, name: str):
    """Lower an uploaded SASS trace text (sim/traceio.py subset grammar)
    into a Workload named ``trace:<name>``."""
    from repro_torch.sim import traceio
    from repro_torch.sim.trace import Workload

    try:
        parsed = traceio.parse_trace_text(text, path=f"<upload:{name}>")
    except traceio.TraceFormatError as e:
        raise ServiceError(str(e), "trace_text") from None
    kernels = []
    for pk in parsed:
        kt, _ = traceio.lower_kernel(pk)
        kernels.append(kt)
    return Workload(f"trace:{name}", kernels)


def build_job(payload: dict, base: GPUConfig, scfg, seq: int) -> Job:
    """Validate one submission and admit it as a Job, or raise
    ``ServiceError`` naming the offending field.  Checks, in order:
    field types and exclusivity, workload resolution (zoo name /
    ``trace:<x>`` / uploaded trace text), config-lane construction,
    static-shape invariance, and CTA admission
    (core/batch.py:check_workload_fits — a kernel that could never
    dispatch is rejected by name instead of spinning to max_cycles)."""
    from repro_torch.core.batch import check_workload_fits

    if not isinstance(payload, dict):
        raise ServiceError(
            f"submission must be a JSON object, got "
            f"{type(payload).__name__}")
    known = {"op", "id", "workload", "trace_text", "scale", "config",
             "configs", "sample"}
    unknown = set(payload) - known
    if unknown:
        raise ServiceError(f"unknown field(s) {sorted(unknown)}; known "
                           f"fields: {sorted(known - {'op'})}",
                           sorted(unknown)[0])
    job_id = payload.get("id", f"job-{seq}")
    if not isinstance(job_id, str):
        raise ServiceError("job id must be a string", "id")

    wl_name = payload.get("workload")
    trace_text = payload.get("trace_text")
    if (wl_name is None) == (trace_text is None):
        raise ServiceError(
            "exactly one of 'workload' (zoo / trace:<x> name) or "
            "'trace_text' (uploaded SASS trace) is required", "workload")
    scale = payload.get("scale", 1.0)
    if isinstance(scale, bool) or not isinstance(scale, (int, float)) \
            or scale <= 0:
        raise ServiceError(f"scale must be a positive number, got "
                           f"{scale!r}", "scale")

    if trace_text is not None:
        if not isinstance(trace_text, str) or not trace_text.strip():
            raise ServiceError("trace_text must be non-empty SASS trace "
                               "text", "trace_text")
        w = _workload_from_trace_text(trace_text, job_id)
        if scale != 1.0:
            from repro_torch.sim.traceio import scale_trace_workload
            w = scale_trace_workload(w, float(scale))
    else:
        if not isinstance(wl_name, str):
            raise ServiceError("workload must be a name string",
                               "workload")
        from repro_torch.sim.workloads import resolve_workload
        try:
            w = resolve_workload(wl_name, scale=float(scale))
        except (KeyError, FileNotFoundError) as e:
            raise ServiceError(str(e), "workload") from None

    given = [k for k in ("config", "configs", "sample") if k in payload]
    if len(given) > 1:
        raise ServiceError(
            f"'config', 'configs' and 'sample' are exclusive, got "
            f"{given}", given[1])
    if "sample" in payload:
        cfgs = _sample_cfgs(base, payload["sample"])
    elif "configs" in payload:
        lanes = payload["configs"]
        if not isinstance(lanes, list) or not lanes:
            raise ServiceError("configs must be a non-empty list of "
                               "override objects", "configs")
        cfgs = [apply_overrides(base, o, f"configs[{i}]")
                for i, o in enumerate(lanes)]
    else:
        cfgs = [apply_overrides(base, payload.get("config", {}))]

    for i, cfg in enumerate(cfgs):
        if static_part(cfg) != scfg:
            raise ServiceError(
                "override changes the server's StaticConfig shape (one "
                "shape = one compiled program family)",
                "config" if len(cfgs) == 1 else f"configs[{i}]")
    try:
        check_workload_fits(scfg, w)
    except ValueError as e:
        raise ServiceError(str(e), "workload") from None
    return Job(seq=seq, id=job_id, name=w.name,
               pairs=[(w, cfg) for cfg in cfgs])


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class SimService:
    """The persistent simulation server core: admission queue, batch
    former, pair-lane executor, result router.  Transport-free — see
    launch/serve.py for the line-JSON frontends.

    ``start=True`` runs the scheduler thread (production / soak shape);
    ``start=False`` leaves batch formation to explicit ``run_pending()``
    calls, which the conformance tests use to place batch boundaries
    exactly where they want them.  Batches run on ``device``: the CUDA
    card unless it names another."""

    def __init__(self, base: GPUConfig = TINY, plan: RunPlan = None,
                 batch_lanes: int = 8, max_wait_s: float = 0.05,
                 lane_quantum: int | None = None, start: bool = True,
                 manifests: bool = False, manifest_dir: str = None,
                 on_done=None, device=None):
        self.base = base
        self.scfg = static_part(base)
        self.device = resolve_device(device)
        self.plan = plan if plan is not None else RunPlan(
            max_cycles=1 << 15, bucket_by="shape")
        if self.plan.mesh is not None:
            raise ValueError("SimService serves pair lanes; mesh "
                             "distribution is not wired (RunPlan.mesh "
                             "must be None)")
        self.batch_lanes = max(int(batch_lanes), 1)
        self.max_wait_s = float(max_wait_s)
        self.lane_quantum = lane_quantum
        self.manifests = manifests
        self.manifest_dir = manifest_dir
        self.on_done = on_done          # callback(job) as results route
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list = []
        self._seq = 0
        self._flush = False
        self._stopping = False
        self.counters = {"submitted": 0, "served": 0, "rejected": 0,
                         "errors": 0, "batches": 0, "lanes": 0,
                         "aot_hits": 0}     # the reference's key; stays 0
        self._started_t = time.time()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._worker, name="sim-service", daemon=True)
            self._thread.start()

    # -- client surface -----------------------------------------------------

    def submit(self, payload: dict) -> Job:
        """Admit one submission (raises ServiceError on bad input) and
        queue it for the next batch."""
        with self._cond:
            if self._stopping:
                raise ServiceError("server is shutting down")
            self._seq += 1
            seq = self._seq
        try:
            job = build_job(payload, self.base, self.scfg, seq)
        except ServiceError:
            with self._cond:
                self.counters["rejected"] += 1
            raise
        job.submitted_t = time.time()
        with self._cond:
            self._pending.append(job)
            self.counters["submitted"] += 1
            self._cond.notify_all()
        return job

    def flush(self) -> None:
        """Ask the batch former to run the queue now, deadline or not."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters,
                        pending=len(self._pending),
                        batch_lanes=self.batch_lanes,
                        max_wait_s=self.max_wait_s,
                        uptime_s=round(time.time() - self._started_t, 3),
                        plan=self.plan.describe())

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until the queue is empty and every submitted job has
        routed.  With no scheduler thread, runs the batches inline."""
        deadline = time.time() + timeout
        if self._thread is None:
            while self.run_pending():
                if time.time() > deadline:
                    return False
            return True
        self.flush()
        while time.time() < deadline:
            with self._lock:
                if not self._pending and \
                        self.counters["served"] + self.counters["errors"] \
                        >= self.counters["submitted"]:
                    return True
            self.flush()
            time.sleep(0.005)
        return False

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        if drain:
            self.drain(timeout)
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- batch formation ----------------------------------------------------

    def _take_batch(self) -> list:
        """Pop the ENTIRE pending queue (FIFO).  Taking everything each
        time is the no-starvation guarantee: a job can never be passed
        over in favor of later arrivals."""
        jobs, self._pending = self._pending, []
        self._flush = False
        return jobs

    def run_pending(self) -> int:
        """Synchronously form and run ONE batch from whatever is queued.
        Returns the number of jobs served (0 = queue was empty).  The
        test-facing entry point: batch boundaries land exactly where the
        caller's submit/run_pending interleaving puts them."""
        with self._cond:
            jobs = self._take_batch()
        if jobs:
            self._run_batch(jobs)
        return len(jobs)

    def _lanes_waiting(self) -> int:
        return sum(j.n_lanes for j in self._pending)

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and not self._ready_locked():
                    oldest = (self._pending[0].submitted_t
                              if self._pending else None)
                    wait = None
                    if oldest is not None:
                        wait = max(oldest + self.max_wait_s - time.time(),
                                   0.001)
                    self._cond.wait(timeout=wait)
                if self._stopping and not self._pending:
                    return
                jobs = self._take_batch()
            if jobs:
                try:
                    self._run_batch(jobs)
                except Exception as e:  # noqa: BLE001 — route, don't die
                    self._fail_batch(jobs, e)

    def _ready_locked(self) -> bool:
        if not self._pending:
            return False
        if self._flush or self._stopping:
            return True
        if self._lanes_waiting() >= self.batch_lanes:
            return True
        return time.time() - self._pending[0].submitted_t >= self.max_wait_s

    # -- execution + result routing -----------------------------------------

    def _run_batch(self, jobs: list) -> None:
        t_start = time.time()
        for j in jobs:
            j.started_t = t_start
        pairs = [p for j in jobs for p in j.pairs]
        result = pair_sweep(pairs, plan=self.plan,
                            lane_quantum=self.lane_quantum,
                            device=self.device)
        t_done = time.time()
        tm = result.timings
        batch_info = {
            "n_jobs": len(jobs), "n_lanes": len(pairs),
            "n_buckets": tm.get("n_buckets"),
            "compile_s": tm.get("compile_s"),
            "execute_s": tm.get("execute_s"),
            "aot_cache": None,          # nothing compiled, nothing cached
        }
        with self._lock:
            self.counters["batches"] += 1
            self.counters["lanes"] += len(pairs)
        base = 0
        for job in jobs:
            job.stats = result.stats[base:base + job.n_lanes]
            base += job.n_lanes
            job.batch = batch_info
            job.done_t = t_done
            if self.manifests:
                from repro_torch.core import telemetry
                job.manifest = telemetry.write_job_manifest(
                    job, scfg=self.scfg, out_dir=self.manifest_dir,
                    device=self.device)
            with self._lock:
                self.counters["served"] += 1
            job._event.set()
            if self.on_done is not None:
                self.on_done(job)

    def _fail_batch(self, jobs: list, err: Exception) -> None:
        """A batch that failed to execute routes the error to every job
        in it rather than leaving clients hanging."""
        for job in jobs:
            job.error = f"{type(err).__name__}: {err}"
            job.done_t = time.time()
            with self._lock:
                self.counters["errors"] += 1
            job._event.set()
            if self.on_done is not None:
                self.on_done(job)

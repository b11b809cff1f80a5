"""The port's simulation server (core/service.py) against the JAX package's,
and its conformance suite, mirrored from tests/test_service.py.

The server's determinism contract: every served lane is bit-identical
(``comparable()`` + timeout accounting) to a solo ``simulate()`` run of
its (workload, config) pair — regardless of which strangers it was
co-batched with, the arrival order, or where the batch boundaries fell.

Against the JAX package, ``build_job`` admits the same submissions with
equal (workload, config) lanes, and rejects the same malformed ones with
equal field names and messages.  The reference's own submission pool
(tests/test_service.py, scale 0.02) is the pool of ``--selftest``:
tests/test_torch_serve.py holds its served batch against
tests/golden/torch_port_service.json, the JAX package's ``SimService``
responses without their timings, which ``_regen`` here writes.

The conformance suite runs on the CPU over a cheaper pool (the zoo at
scale 0.002 to 0.005 and the bundled traces), with distinct footprints,
a config-override lane, a two-lane sample grid and a trace upload.  The
reference's warm-restart case becomes the port's refusal of
``cache_dir``: the port compiles nothing, so a batch reports
``compile_s`` None.

Regenerate the golden from the JAX package with
    PYTHONPATH=src python tests/test_torch_service.py --regen
"""
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import repro.core.service as JSV
import repro.core.telemetry as JT
import repro.sim.config as JC
from repro.launch import report as jreport
from repro_torch.convert import to_numpy
from repro_torch.core import stats as S
from repro_torch.core import telemetry as T
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.service import ServiceError, SimService, build_job
from repro_torch.launch import report
from repro_torch.sim.config import TINY, static_part
from repro_torch.sim.workloads import trace_search_dirs
from _hyp import given, settings, st

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_port_service.json")
MAX_CYCLES = 1 << 15
PLAN = RunPlan(max_cycles=MAX_CYCLES, bucket_by="shape")

# tests/test_service.py's pool, the golden's jobs (in this order)
GOLDEN_SUBS = {
    "zoo": {"workload": "mixed", "scale": 0.02},
    "cfg": {"workload": "reduction_tree", "scale": 0.02,
            "config": {"l2_lat": 64, "scheduler": "lrr"}},
    "trace": {"workload": "trace:vecadd"},
    "grid": {"workload": "streaming_copy", "scale": 0.02,
             "sample": {"n": 2, "lat": [["fp32", 2, 8]]}},
}
# the conformance pool: the same shapes of submission, cheaper workloads
# (a lockstep batch runs to its longest lane, each ~0.2-0.6 s here)
SCALE = 0.005
SUBS = {
    "zoo": {"workload": "strided_transpose", "scale": 0.002},
    "cfg": {"workload": "reduction_tree", "scale": SCALE,
            "config": {"l2_lat": 64, "scheduler": "lrr"}},
    "trace": {"workload": "trace:vecadd"},
    "grid": {"workload": "trace:gather_chain",
             "sample": {"n": 2, "lat": [["fp32", 2, 8]]}},
}

# tests/test_service.py's malformed submissions and the field each names
MALFORMED = [
    ({}, "workload"),                                    # neither source
    ({"workload": "mixed", "trace_text": "x"}, "workload"),   # both
    ({"workload": "no_such_zoo_name"}, "workload"),
    ({"workload": 7}, "workload"),
    ({"trace_text": ""}, "trace_text"),
    ({"trace_text": "not a trace at all"}, "trace_text"),
    ({"workload": "mixed", "scale": -1}, "scale"),
    ({"workload": "mixed", "scale": True}, "scale"),
    ({"workload": "mixed", "config": {"n_sm": 4}}, "config.n_sm"),
    ({"workload": "mixed", "config": {"l2_lat": 1.5}}, "config.l2_lat"),
    ({"workload": "mixed", "config": {"scheduler": "fifo"}},
     "config.scheduler"),
    ({"workload": "mixed", "config": {"lat_of_class": [1, 2]}},
     "config.lat_of_class"),
    ({"workload": "mixed", "config": 3}, "config"),
    ({"workload": "mixed", "configs": []}, "configs"),
    ({"workload": "mixed", "configs": [{"bogus_knob": 1}]},
     "configs[0].bogus_knob"),
    ({"workload": "mixed", "config": {}, "sample": {"n": 2}}, "sample"),
    ({"workload": "mixed", "sample": {"n": 0}}, "sample.n"),
    ({"workload": "mixed", "sample": {"n": 2, "lat": [["fp32", 2]]}},
     "sample.lat"),
    ({"workload": "mixed", "sample": {"wat": 1}}, "sample"),
    ({"workload": "mixed", "id": 9}, "id"),
    ({"workload": "mixed", "surprise": 1}, "surprise"),
]


@pytest.fixture(autouse=True)
def _one_thread():
    """The simulator's tensors are tiny; torch's intra-op threads only add
    contention between test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sig(stats):
    return dict(S.comparable(stats), timeouts=stats["timeouts"])


_solo_cache = {}


def solo_sigs(job):
    """Expected per-lane signatures for an admitted job, computed from
    the port's solo ``simulate()`` runs on the CPU (memoized: the pool
    reuses pairs)."""
    out = []
    for w, cfg in job.pairs:
        key = (w.name, cfg)
        if key not in _solo_cache:
            _solo_cache[key] = sig(S.finalize(simulate(
                w, cfg, make_sm_runner(cfg, "vmap"),
                plan=RunPlan(max_cycles=MAX_CYCLES), device="cpu")))
        out.append(_solo_cache[key])
    return out


def check_job(job):
    assert job.done and job.error is None, job.response()
    assert [sig(s) for s in job.stats] == solo_sigs(job), job.id


def sync_service(**kw):
    kw.setdefault("plan", PLAN)
    return SimService(base=TINY, start=False, device="cpu", **kw)


def vecadd_text():
    for d in trace_search_dirs():
        path = os.path.join(d, "vecadd.trace")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
    pytest.skip("bundled vecadd.trace not found")


def oversized_trace_text():
    """The bundled vecadd trace with a 512-thread block: 16 warps per
    CTA, twice TINY's 8 warp slots — lowers fine, can never dispatch."""
    return vecadd_text().replace("-block dim = (64,1,1)",
                                 "-block dim = (512,1,1)")


def golden_record(jobs) -> list:
    """What the golden keeps of each served job: its response without
    timings or manifest, the batch by its packing only."""
    out = []
    for job in jobs:
        r = job.response()
        out.append({"id": r["id"], "workload": r["workload"],
                    "lanes": r["lanes"], "stats": r["stats"],
                    "batch": {k: r["batch"][k]
                              for k in ("n_jobs", "n_lanes", "n_buckets")}})
    return out


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _uploads():
    return {"upload": {"id": "upload", "trace_text": vecadd_text()},
            "upload_scaled": {"id": "up2", "trace_text": vecadd_text(),
                              "scale": 2.0},
            "configs": {"workload": "trace:mm_tile",
                        "configs": [{}, {"l2_lat": 48},
                                    {"disp_of_class": [1] * 7}]},
            "seeded": {"workload": "mixed", "scale": SCALE,
                       "sample": {"n": 3, "disp": [["sfu", 1, 6]],
                                  "seed": 7}}}


ADMITTED = ([("golden", k) for k in GOLDEN_SUBS] + [("pool", k) for k in SUBS]
            + [("extra", k) for k in ("upload", "upload_scaled", "configs",
                                      "seeded")])


@pytest.mark.parametrize("pool,key", ADMITTED)
def test_build_job_admits_as_reference(pool, key):
    payload = {"golden": GOLDEN_SUBS, "pool": SUBS}.get(pool) or _uploads()
    payload = payload[key]
    got = build_job(payload, TINY, static_part(TINY), seq=3)
    want = JSV.build_job(payload, JC.TINY, JC.split_config(JC.TINY)[0],
                         seq=3)
    assert (got.seq, got.id, got.name, got.n_lanes) == \
        (want.seq, want.id, want.name, want.n_lanes)
    for (w, cfg), (jw, jcfg) in zip(got.pairs, want.pairs):
        assert vars(cfg) == vars(jcfg)
        assert w.name == jw.name and len(w.kernels) == len(jw.kernels)
        for k, jk in zip(w.kernels, jw.kernels):
            assert k.name == jk.name
            mine = to_numpy(k.pack("cpu"))
            for f, v in jk.pack().items():
                v = np.asarray(v)
                assert mine[f].dtype == v.dtype and \
                    np.array_equal(mine[f], v), (key, k.name, f)


@pytest.mark.parametrize("payload,fieldname", MALFORMED + [
    ("oversized", "workload"),
    ({"workload": "mixed", "config": {"icnt_lat": 8}}, "config"),
    ([1, 2], None),
])
def test_build_job_rejects_as_reference(payload, fieldname):
    if payload == "oversized":
        payload = {"trace_text": oversized_trace_text()}
    with pytest.raises(ServiceError) as got:
        build_job(payload, TINY, static_part(TINY), seq=1)
    with pytest.raises(JSV.ServiceError) as want:
        JSV.build_job(payload, JC.TINY, JC.split_config(JC.TINY)[0], seq=1)
    assert got.value.field == want.value.field == fieldname
    assert str(got.value) == str(want.value)


def test_config_keys_equal_reference():
    from repro_torch.core import service
    assert service.CONFIG_KEYS == JSV.CONFIG_KEYS


# ---------------------------------------------------------------------------
# co-batching invariance: the conformance core
# ---------------------------------------------------------------------------

def test_solo_batch_matches_solo_run():
    svc = sync_service()
    job = svc.submit(SUBS["zoo"])
    assert svc.run_pending() == 1
    check_job(job)
    assert job.latency()["total_s"] >= 0.0
    assert job.latency()["compile_s"] is None


def test_cobatched_with_strangers_identical():
    """The same submission alone, co-batched with three strangers, and
    split across flush boundaries: three bit-identical results."""
    alone = sync_service()
    a = alone.submit(SUBS["zoo"])
    alone.run_pending()

    together = sync_service()
    jobs = [together.submit(SUBS[k]) for k in
            ("zoo", "cfg", "trace", "grid")]
    served = together.run_pending()
    assert served == 4
    assert jobs[0].batch["n_jobs"] == 4 and jobs[0].batch["n_lanes"] == 5

    split = sync_service()
    s1 = split.submit(SUBS["zoo"])
    split.run_pending()                      # boundary between the two
    s2 = [split.submit(SUBS[k]) for k in ("cfg", "trace", "grid")]
    split.run_pending()

    for job in [a] + jobs + [s1] + s2:
        check_job(job)
    assert sig(a.stats[0]) == sig(jobs[0].stats[0]) == sig(s1.stats[0])


def test_lane_quantum_padding_is_live_and_inert():
    """lane_quantum rounds the bucket up by repeating live lanes; the
    duplicates change nothing about any job's result."""
    svc = sync_service(lane_quantum=4)
    jobs = [svc.submit(SUBS[k]) for k in ("zoo", "cfg", "trace")]
    svc.run_pending()
    for job in jobs:
        check_job(job)


def test_arrival_order_irrelevant():
    orders = [("zoo", "cfg", "trace"), ("trace", "zoo", "cfg"),
              ("cfg", "trace", "zoo")]
    results = []
    for order in orders:
        svc = sync_service()
        jobs = {k: svc.submit(SUBS[k]) for k in order}
        svc.run_pending()
        results.append({k: sig(j.stats[0]) for k, j in jobs.items()})
    assert results[0] == results[1] == results[2]
    for job in jobs.values():
        check_job(job)


# ---------------------------------------------------------------------------
# admission + validation: errors name the offending field
# ---------------------------------------------------------------------------

def test_oversized_cta_rejected_by_name():
    svc = sync_service()
    with pytest.raises(ServiceError, match="could never dispatch"):
        svc.submit({"trace_text": oversized_trace_text()})
    assert svc.stats()["rejected"] == 1
    assert svc.stats()["pending"] == 0


@pytest.mark.parametrize("payload,fieldname", MALFORMED)
def test_malformed_submission_names_field(payload, fieldname):
    svc = sync_service()
    with pytest.raises(ServiceError) as ei:
        svc.submit(payload)
    assert ei.value.field == fieldname
    assert repr(fieldname) in str(ei.value)   # message carries the name
    assert svc.stats()["pending"] == 0


def test_static_shape_override_rejected():
    """Dynamic-key overrides that sneak in a static-shape change are
    impossible by construction (only DYN keys are accepted), and the
    residual guard still runs — build_job on a foreign base raises."""
    import dataclasses
    other = dataclasses.replace(TINY, n_sm=4)
    with pytest.raises(ServiceError, match="StaticConfig shape"):
        build_job({"workload": "mixed", "scale": SCALE},
                  other, static_part(TINY), seq=1)


def test_trace_text_upload_serves():
    """An uploaded trace body (not a registered name) is lowered, served,
    and bit-identical to simulating the lowered workload directly."""
    svc = sync_service()
    job = svc.submit({"id": "upload", "trace_text": vecadd_text()})
    svc.run_pending()
    check_job(job)
    assert job.name == "trace:upload"


def test_service_runs_on_the_card_unless_asked():
    """Without ``device`` the server takes the CUDA card, and without one
    it raises, naming the way to ask for the CPU; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the server takes it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SimService(base=TINY, start=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SimService(base=TINY, start=True)
    assert not any(t.name == "sim-service" and t.is_alive()
                   for t in threading.enumerate())


# ---------------------------------------------------------------------------
# soak: threaded server, multi-client, nothing starved or dropped
# ---------------------------------------------------------------------------

def test_soak_multiclient_threaded():
    """4 client threads × 3 mixed submissions against ONE live server
    (scheduler thread, small batch/deadline so several batches form).
    Every response arrives, none errors, every lane is bit-exact, and
    the queue drains."""
    svc = SimService(base=TINY, plan=PLAN, batch_lanes=4,
                     max_wait_s=0.01, start=True, device="cpu")
    keys = list(SUBS)
    jobs, jobs_lock = [], threading.Lock()

    def client(ci):
        for j in range(3):
            job = svc.submit(dict(SUBS[keys[(ci + j) % len(keys)]],
                                  id=f"c{ci}-{j}"))
            with jobs_lock:
                jobs.append(job)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive()
    assert svc.drain(timeout=300.0), svc.stats()
    svc.shutdown(drain=False)

    assert len(jobs) == 12
    for job in jobs:
        assert job.wait(timeout=1.0), f"{job.id} starved"
        check_job(job)
    counters = svc.stats()
    assert counters["served"] == counters["submitted"] == 12
    assert counters["errors"] == 0 and counters["pending"] == 0
    assert counters["batches"] >= 1
    assert {j.id for j in jobs} == \
        {f"c{c}-{j}" for c in range(4) for j in range(3)}


def test_batch_failure_routes_error_to_jobs(monkeypatch):
    """An execution failure mid-batch must answer every affected client,
    not hang them: jobs report status=error, counters record it."""
    svc = SimService(base=TINY, plan=PLAN, batch_lanes=2,
                     max_wait_s=0.01, start=True, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected batch failure")
    monkeypatch.setattr("repro_torch.core.service.pair_sweep", boom)
    jobs = [svc.submit(SUBS["zoo"]), svc.submit(SUBS["cfg"])]
    for job in jobs:
        assert job.wait(timeout=30.0)
        assert job.error is not None
        resp = job.response()
        assert resp["ok"] is False and "injected" in resp["error"]
        json.dumps(resp)
    assert svc.stats()["errors"] == 2
    svc.shutdown(drain=False)


# ---------------------------------------------------------------------------
# restart over a cache_dir: refused (the port compiles nothing to cache)
# ---------------------------------------------------------------------------

def test_restart_same_cache_dir_refused(tmp_path):
    """The reference's restarted server serves its first batch off the
    warm executable caches of ``cache_dir``.  The port compiles no
    program: a plan with ``cache_dir`` is refused before any server
    starts, and a served batch reports ``compile_s`` None and no hit."""
    with pytest.raises(NotImplementedError, match="graph cache"):
        RunPlan(max_cycles=MAX_CYCLES, bucket_by="shape",
                cache_dir=str(tmp_path / "xla-cache"))
    first = sync_service()
    j1 = first.submit(SUBS["trace"])
    first.run_pending()
    second = sync_service()                  # the "restart"
    j2 = second.submit(SUBS["trace"])
    second.run_pending()
    for job in (j1, j2):
        check_job(job)
        assert job.batch["compile_s"] is None
        assert job.batch["aot_cache"] is None
    assert sig(j1.stats[0]) == sig(j2.stats[0])
    assert second.stats()["aot_hits"] == 0


# ---------------------------------------------------------------------------
# per-job manifests
# ---------------------------------------------------------------------------

def test_job_manifest_as_reference(tmp_path, monkeypatch, capsys):
    """A served job's manifest (written to the redirected runs directory)
    has the reference's keys and timings keys, the server's device in
    ``host``, and both packages' report CLI render it alike."""
    runs = tmp_path / "runs"
    monkeypatch.setattr(T, "runs_dir", lambda: str(runs))
    svc = sync_service(manifests=True)
    job = svc.submit(SUBS["grid"])
    svc.run_pending()
    check_job(job)
    assert job.manifest and os.path.dirname(job.manifest) == str(runs)
    with open(job.manifest) as f:
        m = json.load(f)
    jjob = JSV.build_job(SUBS["grid"], JC.TINY,
                         JC.split_config(JC.TINY)[0], seq=job.seq)
    jjob.stats, jjob.batch = job.stats, job.batch
    jpath = JT.write_job_manifest(jjob, scfg=JC.split_config(JC.TINY)[0],
                                  out_dir=str(tmp_path / "jax"))
    with open(jpath) as f:
        want = json.load(f)
    assert m["kind"] == want["kind"] == "serve_job"
    assert set(m) == set(want)
    assert set(m["timings"]) == set(want["timings"])
    assert m["static_config_hash"] == want["static_config_hash"]
    assert m["host"]["device_platform"] == "cpu"
    assert m["stats"] == want["stats"] and m["job"] == want["job"]
    assert m["lanes"] == [{"workload": "trace:gather_chain"}] * 2
    for argv in (["list", str(runs)], ["summarize", job.manifest]):
        capsys.readouterr()
        assert report.main(argv) == 0
        got = capsys.readouterr().out
        assert jreport.main(argv) == 0
        assert got == capsys.readouterr().out and "serve_job" in got, argv


# ---------------------------------------------------------------------------
# property: random submit/flush interleavings are order-independent
# ---------------------------------------------------------------------------

def _run_script(script):
    svc = sync_service()
    jobs = []
    for step in script:
        if step == "FLUSH":
            svc.run_pending()
        else:
            jobs.append((step, svc.submit(SUBS[step])))
    while svc.run_pending():
        pass
    for key, job in jobs:
        check_job(job)


@settings(max_examples=5, deadline=None)
@given(st.lists(st.sampled_from(sorted(SUBS) + ["FLUSH"]),
                min_size=1, max_size=6))
def test_interleaving_order_independent(script):
    """Any interleaving of submissions and batch boundaries — including
    duplicate submissions of the same job — yields the same per-job
    signatures as the solo runs."""
    _run_script(script)


@pytest.mark.parametrize("script", [
    ["trace", "FLUSH", "trace", "cfg"],
    ["grid", "zoo", "FLUSH", "FLUSH", "grid"],
    ["cfg", "trace", "grid", "FLUSH", "zoo", "cfg"],
])
def test_interleaving_fixed_scripts(script):
    """Three fixed interleavings, duplicates and an empty flush among
    them, so the property holds where hypothesis is absent too."""
    _run_script(script)


# ---------------------------------------------------------------------------
# the golden, from the JAX package
# ---------------------------------------------------------------------------

def _regen(path=GOLDEN):
    from repro.core.plan import RunPlan as JPlan
    svc = JSV.SimService(base=JC.TINY, plan=JPlan(max_cycles=MAX_CYCLES,
                                                  bucket_by="shape"),
                         start=False)
    jobs = [svc.submit(s) for s in GOLDEN_SUBS.values()]
    assert svc.run_pending() == len(jobs)
    golden = {"source": "tests/test_service.py's pool served in one batch "
                        "by the JAX package's SimService (TINY)",
              "max_cycles": MAX_CYCLES, "bucket_by": "shape",
              "subs": list(GOLDEN_SUBS.values()), "jobs": golden_record(jobs)}
    with open(path, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()

"""The port's server frontends (launch/serve.py) and CLI knobs
(launch/cli.py:add_service_args, service_from_args) against the JAX
package's.

``handle_line`` replies as the reference's on the same lines; the stdin
frontend serves a scripted session; the socket frontend, bound to an
ephemeral port, routes every completion to the connection that
submitted it; ``--selftest`` passes on the CPU, and its first batch —
tests/test_service.py's pool — equals the JAX package's golden; the
parser yields the reference's defaults.  Everything runs on
``device="cpu"`` and TINY.
"""
import io
import json
import queue
import re
import socket
import sys
import threading

import pytest
import torch

import repro.core.service as JSV
from repro.core.plan import RunPlan as JPlan
from repro.launch import serve as jserve
from repro.sim.config import TINY as JTINY
from repro_torch.core import service
from repro_torch.core import stats as S
from repro_torch.core.engine import simulate
from repro_torch.core.parallel import make_sm_runner
from repro_torch.core.plan import RunPlan
from repro_torch.core.service import SimService
from repro_torch.launch import serve
from repro_torch.launch.cli import add_plan_args, add_service_args
from repro_torch.sim.config import TINY
from repro_torch.sim.workloads import resolve_workload
from test_torch_service import GOLDEN, GOLDEN_SUBS, golden_record

MAX_CYCLES = 1 << 15
PLAN = RunPlan(max_cycles=MAX_CYCLES, bucket_by="shape")
# cheap jobs: a bundled trace, and one with a config override
VECADD = {"op": "submit", "id": "a", "workload": "trace:vecadd"}
GATHER = {"op": "submit", "id": "b", "workload": "trace:gather_chain",
          "config": {"l2_lat": 64, "scheduler": "lrr"}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solo(payload) -> dict:
    """``comparable()`` of a solo CPU run of a pool job's one lane."""
    import dataclasses
    cfg = dataclasses.replace(TINY, **payload.get("config", {}))
    return S.comparable(S.finalize(simulate(
        resolve_workload(payload["workload"]), cfg,
        make_sm_runner(cfg, "vmap"), plan=RunPlan(max_cycles=MAX_CYCLES),
        device="cpu")))


def replies_to(svc, handle, line):
    out = []
    keep = handle(svc, line, out.append)
    return keep, out


@pytest.mark.parametrize("line", [
    json.dumps(VECADD),
    json.dumps({"workload": "trace:vecadd"}),          # no op: a submit
    json.dumps({"op": "submit", "workload": "mixed", "scale": 0.005,
                "sample": {"n": 3, "lat": [["fp32", 2, 8]]}}),
    json.dumps({"op": "submit", "workload": "no_such_zoo_name"}),
    json.dumps({"op": "submit", "workload": "mixed",
                "config": {"n_sm": 4}}),
    json.dumps([1, 2]),
    "{not json",
    json.dumps({"op": "launch"}),
    json.dumps({"op": "flush"}),
    json.dumps({"op": "stats"}),
    json.dumps({"op": "shutdown"}),
    "   ",
])
def test_handle_line_replies_as_reference(line):
    """Each reply equals the reference's on the same line, but for the
    server's uptime (a timing)."""
    mine = SimService(base=TINY, plan=PLAN, start=False, device="cpu")
    ref = JSV.SimService(base=JTINY, start=False, plan=JPlan(
        max_cycles=MAX_CYCLES, bucket_by="shape"))
    got = replies_to(mine, serve.handle_line, line)
    want = replies_to(ref, jserve.handle_line, line)
    for _, out in (got, want):
        for r in out:
            r.pop("uptime_s", None)
            json.dumps(r)
    assert got == want


def _lines(text):
    return [json.loads(x) for x in text.splitlines() if x.strip()]


def test_serve_stdin_scripted(monkeypatch):
    """A scripted session on stdin: two submits, a malformed line, flush,
    stats, shutdown.  Every line out is JSON; the completions equal solo
    runs and arrive before the server returns."""
    script = "\n".join([json.dumps(VECADD), json.dumps(GATHER),
                        json.dumps({"op": "submit", "workload": 7}),
                        json.dumps({"op": "flush"}),
                        json.dumps({"op": "stats"}),
                        json.dumps({"op": "shutdown"}),
                        json.dumps({"op": "submit", "id": "late",
                                    "workload": "trace:vecadd"})]) + "\n"
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO(script))
    monkeypatch.setattr(sys, "stdout", out)
    svc = SimService(base=TINY, plan=PLAN, start=True, device="cpu")
    serve.serve_stdin(svc)
    lines = _lines(out.getvalue())
    by_status = {}
    for r in lines:
        by_status.setdefault(r.get("status"), []).append(r)
    assert [r["id"] for r in by_status["queued"]] == ["a", "b"]
    assert [r for r in lines if not r["ok"]] == [{
        "ok": False, "field": "workload",
        "error": "field 'workload': workload must be a name string"}]
    assert by_status["flushed"] == [{"ok": True, "status": "flushed"}]
    assert by_status["draining"] == [{"ok": True, "status": "draining"}]
    done = {r["id"]: r for r in by_status["done"]}
    assert sorted(done) == ["a", "b"]            # the line after shutdown
    for payload in (VECADD, GATHER):             # is never read
        assert done[payload["id"]]["stats"] == [solo(payload)]
    stats = [r for r in lines if "submitted" in r]
    assert len(stats) == 1 and stats[0]["rejected"] == 1
    assert svc.stats()["served"] == 2 and svc.stats()["pending"] == 0


class _Lines:
    """A stderr stand-in that hands each written line to a queue."""

    def __init__(self):
        self.q = queue.Queue()

    def write(self, text):
        for line in text.splitlines():
            self.q.put(line)

    def flush(self):
        pass


def test_serve_socket_routes_to_submitter(monkeypatch):
    """``serve_socket`` on port 0: the ``listening on host:port`` line
    names the port; two connections each get their own acks and only
    their own completions; shutdown drains and returns."""
    err = _Lines()
    monkeypatch.setattr(sys, "stderr", err)
    svc = SimService(base=TINY, plan=PLAN, start=True, device="cpu",
                     batch_lanes=2, max_wait_s=5.0)
    server = threading.Thread(target=serve.serve_socket,
                              args=(svc, "127.0.0.1", 0), daemon=True)
    server.start()
    port = int(re.search(r"listening on 127\.0\.0\.1:(\d+)",
                         err.q.get(timeout=30)).group(1))
    conns = [socket.create_connection(("127.0.0.1", port), timeout=60)
             for _ in range(2)]
    files = [c.makefile("rw") for c in conns]
    for f, payload in zip(files, (VECADD, GATHER)):
        f.write(json.dumps(payload) + "\n")
        f.flush()
    got = []
    for f in files:            # batch_lanes 2: the two lanes form a batch
        got.append([json.loads(f.readline()) for _ in range(2)])
    for (ack, done), payload in zip(got, (VECADD, GATHER)):
        assert ack["status"] == "queued" and ack["id"] == payload["id"]
        assert done["status"] == "done" and done["id"] == payload["id"]
        assert done["stats"] == [solo(payload)]
        assert done["batch"]["n_jobs"] == 2
    files[0].write(json.dumps({"op": "shutdown"}) + "\n")
    files[0].flush()
    assert json.loads(files[0].readline()) == {"ok": True,
                                               "status": "draining"}
    server.join(timeout=60)
    assert not server.is_alive()
    for f, c in zip(files, conns):
        f.close()
        c.close()
    assert svc.stats()["served"] == 2


def test_selftest_serves_the_golden_pool(monkeypatch):
    """``--selftest --device cpu`` exits 0: the reference's mixed zoo +
    trace jobs (tests/test_service.py's pool), bit-identical to solo runs,
    a warm resubmission with equal stats, the rejections by field.  Its
    first batch serves that pool as one batch: every response but the
    client ids equals the JAX package's (tests/golden/
    torch_port_service.json), survives ``json.dumps`` and holds ints."""
    batches = []

    class Recording(service.SimService):
        def run_pending(self):
            jobs = list(self._pending)
            served = super().run_pending()
            batches.append(jobs)
            return served

    monkeypatch.setattr(service, "SimService", Recording)
    with pytest.raises(SystemExit) as ei:
        serve.main(["--selftest", "--device", "cpu"])
    assert ei.value.code == 0
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["max_cycles"] == MAX_CYCLES
    assert golden["subs"] == list(GOLDEN_SUBS.values())
    first, warm = batches

    def anonymous(records):
        return [dict(r, id=None) for r in records]
    assert anonymous(golden_record(first)) == anonymous(golden["jobs"])
    assert anonymous(golden_record(warm)) == anonymous(golden["jobs"])
    for job in first:
        reply = json.loads(json.dumps(job.response()))
        assert reply["stats"] == golden_record([job])[0]["stats"]
        assert all(type(v) is int for s in job.stats
                   for v in S.comparable(s).values())
        assert job.batch["compile_s"] is None
        assert job.batch["aot_cache"] is None


def test_parser_defaults_as_reference():
    """The server's parser yields the reference's defaults, plus
    ``--device`` (None: the card); the service flags carry the
    reference's help text."""
    mine, ref = vars(serve._parse_args([])), vars(jserve._parse_args([]))
    assert mine.pop("device") is None
    assert mine == ref
    assert mine["bucket_by"] == "shape"

    def service_actions(add):
        import argparse
        ap = argparse.ArgumentParser()
        add(ap)
        return [(a.option_strings, a.default, a.help, a.type, a.choices)
                for a in ap._actions if a.dest != "help"]
    from repro.launch import cli as jcli
    assert service_actions(add_service_args) == \
        service_actions(jcli.add_service_args)
    import argparse
    ap = argparse.ArgumentParser()
    add_service_args(ap)
    add_plan_args(ap)
    args = ap.parse_args(["--base", "tiny", "--batch-lanes", "3",
                          "--max-wait-ms", "20", "--lane-quantum", "4",
                          "--device", "cpu"])
    from repro_torch.launch.cli import service_from_args
    svc = service_from_args(args, PLAN)
    try:
        assert (svc.batch_lanes, svc.max_wait_s, svc.lane_quantum,
                str(svc.device)) == (3, 0.02, 4, "cpu")
    finally:
        svc.shutdown(drain=False)


def test_server_needs_the_card_unless_asked():
    """Without ``--device`` the server runs on the CUDA card, and raises
    without one; ``--cache-dir`` is refused (nothing is compiled)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the server takes it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--stdin"])
    with pytest.raises(NotImplementedError, match="graph cache"):
        serve.main(["--stdin", "--device", "cpu", "--cache-dir", "x"])

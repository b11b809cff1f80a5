"""Simulation server frontend: line-JSON over stdin or a TCP socket.

    python -m repro_torch.launch.serve --stdin --base 3080ti
    python -m repro_torch.launch.serve --port 0 --device cpu
    python -m repro_torch.launch.serve --selftest

The port's ``repro.launch.serve``: the transport half of
simulation-as-a-service (core/service.py holds the queue, admission,
batch former and result router).  One warm process serves every
client's jobs: submissions are continuously packed into pair lanes, so
unrelated requests share one lockstep run per bucket.  Runs on the CUDA
device unless ``--device`` names another.

Protocol (one JSON object per line):

  → {"op": "submit", "id"?: str, "workload": "mixed" | "trace:vecadd",
     "scale"?: float, "config"?: {...} | "configs": [{...}] |
     "sample": {"n": 4, "lat": [["fp32", 2, 8]], "seed"?: int}}
    (or "trace_text": "<SASS trace text>" instead of "workload";
     a line with no "op" is treated as a submit)
  ← {"ok": true, "id": ..., "status": "queued", "lanes": N}  on admission
  ← {"ok": false, "error": ..., "field": ...}                on rejection
  ← {"ok": true, "id": ..., "status": "done", "stats": [...],
     "latency": {"queue_s", "compile_s", "execute_s", "total_s"}, ...}
    streamed whenever the job's batch completes (order ≠ submit order)

  → {"op": "flush"}     run the queue now, deadline or not
  → {"op": "stats"}     ← server counters (jobs/batches/pending)
  → {"op": "shutdown"}  drain, then exit

``--port 0`` binds an ephemeral port; the ``[serve] listening on
host:port`` line on stderr names it.  ``--selftest`` runs the in-process
conformance smoke (mixed zoo + trace jobs bit-identical to solo runs; a
warm resubmission gives the same stats) and exits nonzero on any
mismatch.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

from repro_torch.launch.cli import (add_plan_args, add_service_args,
                                    plan_from_args, service_from_args)


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="persistent simulation server (line-JSON protocol)")
    add_service_args(ap)
    add_plan_args(ap)
    # A server co-batches heterogeneous jobs, so same-footprint grouping
    # is the sensible default here (zoo/dse keep bucket_by="none").
    ap.set_defaults(bucket_by="shape")
    ap.add_argument("--stdin", action="store_true",
                    help="serve the line-JSON protocol on stdin/stdout "
                         "(default when no --port)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve the line-JSON protocol on a TCP socket")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--selftest", action="store_true",
                    help="run the in-process conformance smoke and exit")
    return ap.parse_args(argv)


def handle_line(svc, line: str, reply) -> bool:
    """Dispatch one protocol line; ``reply(dict)`` sends a response.
    Returns False when the client asked the server to shut down."""
    from repro_torch.core.service import ServiceError

    line = line.strip()
    if not line:
        return True
    try:
        payload = json.loads(line)
    except json.JSONDecodeError as e:
        reply({"ok": False, "error": f"invalid JSON: {e}"})
        return True
    op = payload.get("op", "submit") if isinstance(payload, dict) \
        else "submit"
    if op == "submit":
        try:
            job = svc.submit(payload)
        except ServiceError as e:
            reply({"ok": False, "error": str(e), "field": e.field})
            return True
        reply({"ok": True, "id": job.id, "job": job.seq,
               "status": "queued", "lanes": job.n_lanes})
    elif op == "flush":
        svc.flush()
        reply({"ok": True, "status": "flushed"})
    elif op == "stats":
        reply(dict({"ok": True}, **svc.stats()))
    elif op == "shutdown":
        reply({"ok": True, "status": "draining"})
        return False
    else:
        reply({"ok": False, "error": f"unknown op {op!r}", "field": "op"})
    return True


def serve_stdin(svc) -> None:
    """The line-JSON protocol over stdin/stdout.  Completions stream on
    stdout interleaved with acks (every line is a self-contained JSON
    object, so clients key on "status")."""
    lock = threading.Lock()

    def reply(obj):
        with lock:
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()

    svc.on_done = lambda job: reply(job.response())
    for line in sys.stdin:
        if not handle_line(svc, line, reply):
            break
    svc.shutdown(drain=True)


def serve_socket(svc, host: str, port: int) -> None:
    """The same protocol over TCP: one thread per connection, and each
    job's completion routes back to the connection that submitted it."""
    import socketserver

    routes: dict = {}          # job seq -> that connection's reply fn
    routes_lock = threading.Lock()

    def on_done(job):
        with routes_lock:
            reply = routes.pop(job.seq, None)
        if reply is not None:
            reply(job.response())
    svc.on_done = on_done

    stop = threading.Event()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            wlock = threading.Lock()

            def reply(obj):
                with wlock:
                    try:
                        self.wfile.write((json.dumps(obj) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass       # client went away; drop the response

            def track(obj):
                if obj.get("status") == "queued":
                    with routes_lock:
                        routes[obj["job"]] = reply
                reply(obj)

            for raw in self.rfile:
                if not handle_line(svc, raw.decode("utf-8", "replace"),
                                   track):
                    stop.set()
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        print(f"[serve] listening on {host}:{srv.server_address[1]} "
              f"(n_sm={svc.base.n_sm}, batch_lanes={svc.batch_lanes})",
              file=sys.stderr, flush=True)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        srv.shutdown()
    svc.shutdown(drain=True)


# ---------------------------------------------------------------------------
# --selftest: the conformance smoke
# ---------------------------------------------------------------------------

def selftest(device=None) -> int:
    """Mixed zoo + trace jobs through a synchronous server on ``device``,
    checked bit-identical to solo ``simulate()`` runs; then the same jobs
    again: the warm batch must give the same stats, and ``compile_s`` is
    None (the port compiles nothing); then admission and validation
    rejections by field name."""
    from repro_torch.core import stats as S
    from repro_torch.core.engine import simulate
    from repro_torch.core.parallel import make_sm_runner
    from repro_torch.core.plan import RunPlan
    from repro_torch.core.service import ServiceError, SimService
    from repro_torch.sim.config import TINY

    max_cycles = 1 << 15
    svc = SimService(base=TINY,
                     plan=RunPlan(max_cycles=max_cycles, bucket_by="shape"),
                     start=False, device=device)
    subs = [
        {"id": "a", "workload": "mixed", "scale": 0.02},
        {"id": "b", "workload": "reduction_tree", "scale": 0.02,
         "config": {"l2_lat": 64, "scheduler": "lrr"}},
        {"id": "c", "workload": "trace:vecadd"},
        {"id": "d", "workload": "streaming_copy", "scale": 0.02,
         "sample": {"n": 2, "lat": [["fp32", 2, 8]]}},
    ]
    jobs = [svc.submit(s) for s in subs]
    served = svc.run_pending()
    _require(served == len(jobs), f"served {served}/{len(jobs)}")

    def sig(st):
        return dict(S.comparable(st), timeouts=st["timeouts"])

    checked = 0
    for job in jobs:
        _require(job.done and job.error is None, job.response())
        for (w, cfg), st in zip(job.pairs, job.stats):
            solo = simulate(w, cfg, make_sm_runner(cfg, "vmap"),
                            plan=RunPlan(max_cycles=max_cycles),
                            device=svc.device)
            _require(sig(st) == sig(S.finalize(solo)),
                     f"lane mismatch for job {job.id} ({w.name})")
            checked += 1
    print(f"[selftest] {checked} served lanes bit-identical to solo runs "
          f"on {svc.device}")

    warm = [svc.submit(s) for s in subs]
    svc.run_pending()
    batch = warm[0].batch
    _require([[sig(s) for s in j.stats] for j in warm]
             == [[sig(s) for s in j.stats] for j in jobs],
             "the warm resubmission's stats differ from the first batch's")
    _require(batch["compile_s"] is None, batch)
    print(f"[selftest] warm resubmission: stats equal, compile_s="
          f"{batch['compile_s']} (nothing compiled), execute_s="
          f"{batch['execute_s']} (first batch {jobs[0].batch['execute_s']})")

    for err_sub, want in [
        ({"workload": "no_such_workload"}, "workload"),
        ({"workload": "mixed", "config": {"n_sm": 99}}, "config.n_sm"),
        ({"workload": "mixed", "trace_text": "k x"}, "workload"),
        ({"trace_text": "this is not a trace"}, "trace_text"),
    ]:
        try:
            svc.submit(err_sub)
        except ServiceError as e:
            _require(e.field == want or (e.field or "").startswith(want),
                     (err_sub, e.field, str(e)))
        else:
            raise AssertionError(f"accepted bad submission {err_sub}")
    print("[selftest] malformed submissions rejected by field name")
    print(f"[selftest] PASS  counters={svc.stats()}")
    return 0


def _require(cond, what) -> None:
    """A selftest check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(what)


def main(argv=None):
    args = _parse_args(argv)
    if args.selftest:
        raise SystemExit(selftest(args.device))
    plan = plan_from_args(args)
    svc = service_from_args(args, plan)
    if args.port is not None:
        serve_socket(svc, args.host, args.port)
    else:
        serve_stdin(svc)
    print(f"[serve] done  {json.dumps(svc.stats())}", file=sys.stderr)


if __name__ == "__main__":
    main()

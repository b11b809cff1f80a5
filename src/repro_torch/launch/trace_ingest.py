"""Trace-ingestion CLI — inspect / summarize / convert Accel-sim SASS
trace subset files (sim/traceio.py) without running the simulator.

  python -m repro_torch.launch.trace_ingest inspect  FILE        # parsed view
  python -m repro_torch.launch.trace_ingest summarize FILE|DIR   # ingest JSON
  python -m repro_torch.launch.trace_ingest convert  FILE [-o OUT.json]
  python -m repro_torch.launch.trace_ingest roundtrip FILE       # conformance

``inspect`` prints each kernel's launch shape and lowered class
histogram; ``summarize`` emits the ``TraceIngest`` JSON (fit-error
stats, dropped ops, divergent warps) for one file or every ``*.trace``
in a directory; ``convert`` dumps the lowered ``KernelTrace`` IR as
JSON (the exact arrays the batched frontend consumes); ``roundtrip``
re-synthesizes the lowered IR back to subset text, re-ingests it, and
verifies the IR is reproduced bit-exactly — the same property the
conformance suite pins (tests/test_traceio.py).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.sim import traceio


def cmd_inspect(args) -> int:
    for path in traceio.trace_files(args.path):
        for pk in traceio.parse_trace_file(path):
            kt, fit = traceio.lower_kernel(pk)
            print(f"kernel {pk.name!r}  grid={pk.grid} block={pk.block} "
                  f"shmem={pk.shmem}")
            print(f"  -> n_ctas={kt.n_ctas} warps_per_cta="
                  f"{kt.warps_per_cta} n_instr={kt.n_instr}")
            print(f"  classes: {traceio.class_histogram(kt)}")
            print(f"  dep chain: {int(kt.dep.sum())}/{kt.n_instr} "
                  f"dependent;  mem ops fitted: {fit.n_mem} "
                  f"(err mean={fit.fit_err_mean:.3f} "
                  f"max={fit.fit_err_max:.3f} blocks)")
            if fit.dropped:
                print(f"  dropped: {fit.dropped}")
            if fit.divergent_warps:
                print(f"  divergent warps (excluded from fit): "
                      f"{fit.divergent_warps}/{fit.n_warps_seen}")
    return 0


def cmd_summarize(args) -> int:
    out = [ing.summary() for ing in traceio.load_traces(args.path)]
    print(json.dumps(out if len(out) > 1 else out[0], indent=1))
    return 0


def cmd_convert(args) -> int:
    ing = traceio.load_trace(args.path)
    payload = {
        "name": ing.workload.name,
        "kernels": [{
            "name": k.name, "n_ctas": k.n_ctas,
            "warps_per_cta": k.warps_per_cta,
            "ops": k.ops.tolist(), "dep": k.dep.tolist(),
            "addr_mode": k.addr_mode.tolist(),
            "addr_param": k.addr_param.tolist(),
        } for k in ing.workload.kernels],
        "ingest": ing.summary(),
    }
    text = json.dumps(payload, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"[trace_ingest] wrote {args.out}")
    else:
        print(text)
    return 0


def cmd_roundtrip(args) -> int:
    ing = traceio.load_trace(args.path)
    text = traceio.synthesize_trace(ing.workload)
    parsed = traceio.parse_trace_text(text, path="<synthesized>")
    ok = True
    for pk, orig in zip(parsed, ing.workload.kernels):
        kt, _ = traceio.lower_kernel(pk)
        if kt != orig:
            ok = False
            print(f"[trace_ingest] ROUNDTRIP MISMATCH in kernel "
                  f"{orig.name!r}", file=sys.stderr)
    if len(parsed) != len(ing.workload.kernels):
        ok = False
    print(f"[trace_ingest] roundtrip "
          f"{'OK' if ok else 'FAILED'}: {len(parsed)} kernel(s)")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Accel-sim SASS trace subset tooling (sim/traceio.py)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn, with_out in (("inspect", cmd_inspect, False),
                               ("summarize", cmd_summarize, False),
                               ("convert", cmd_convert, True),
                               ("roundtrip", cmd_roundtrip, False)):
        p = sub.add_parser(name)
        p.add_argument("path", help=".trace file (or directory for "
                                    "inspect/summarize)")
        if with_out:
            p.add_argument("-o", "--out", default="",
                           help="write JSON here instead of stdout")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

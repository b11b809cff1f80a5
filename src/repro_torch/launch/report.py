"""Run-manifest report CLI — inspect what a run did before touching code.

  python -m repro_torch.launch.report list [DIR]
  python -m repro_torch.launch.report summarize MANIFEST
  python -m repro_torch.launch.report timeline MANIFEST [--lane KEY]
      [--counters issued,l1_miss,...] [--csv] [--cumulative] [--width N]
  python -m repro_torch.launch.report diff A B [--strict]

The port's copy of ``repro.launch.report``: on any manifest, the port's
or the reference's, it prints what the reference prints.

``summarize`` prints a manifest's provenance (git sha, StaticConfig hash,
host and device, mesh shape), the wall-clock split and lanes/sec, and a
per-lane stat table.

``timeline`` renders the sampled counter timelines (core/telemetry.py) as
ASCII sparklines — per-sample deltas by default — or as CSV rows.  When
the manifest carries final stats it also verifies the telemetry
invariant: the last sample of every cumulative counter must equal the
``finalize()`` total (exit 1 if not).

``diff`` compares two runs' ``comparable()`` stats lane by lane — a run
of the port against the reference's run of the same lanes must show no
difference.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.stats import comparable
from repro_torch.core.telemetry import COUNTERS, FINAL_MATCH, runs_dir

BLOCKS = "▁▂▃▄▅▆▇█"


def load(path: str) -> dict:
    with open(path) as f:
        m = json.load(f)
    if not isinstance(m, dict) or "kind" not in m:
        raise SystemExit(f"{path}: not a run manifest")
    return m


def spark(vals, width: int = 64) -> str:
    """ASCII sparkline of a numeric series, resampled to ``width``."""
    if not vals:
        return ""
    if len(vals) > width:                      # downsample by striding
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = max(hi - lo, 1)
    return "".join(BLOCKS[int((v - lo) * (len(BLOCKS) - 1) / span)]
                   for v in vals)


def _deltas(series):
    return [series[0]] + [b - a for a, b in zip(series, series[1:])]


def _lane_stats(manifest: dict):
    return manifest.get("stats") or []


def _timelines(manifest: dict) -> dict:
    return manifest.get("timelines") or {}


def _counter_names(manifest: dict) -> list:
    tel = manifest.get("telemetry") or {}
    return list(tel.get("counters") or COUNTERS)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_list(args) -> int:
    d = args.dir or runs_dir()
    if not os.path.isdir(d):
        print(f"(no runs dir at {d})")
        return 0
    names = sorted(n for n in os.listdir(d) if n.endswith(".json"))
    for n in names:
        try:
            m = load(os.path.join(d, n))
        except (SystemExit, json.JSONDecodeError):
            continue
        t = m.get("timings") or {}
        print(f"{n}  kind={m['kind']}  sha={m.get('git_sha', '?')[:10]}  "
              f"lanes={t.get('n_lanes', '?')}  "
              f"lanes/s={t.get('lanes_per_s', '?')}")
    if not names:
        print(f"(no manifests under {d})")
    return 0


def cmd_summarize(args) -> int:
    m = load(args.manifest)
    host = m.get("host") or {}
    t = m.get("timings") or {}
    print(f"kind:        {m['kind']}")
    print(f"created:     {m.get('created_utc')}")
    print(f"git sha:     {m.get('git_sha')}")
    print(f"static cfg:  {m.get('static_config_hash')}")
    print(f"host:        {host.get('hostname')} "
          f"({host.get('device_platform')}:{host.get('device_kind')} "
          f"x{host.get('device_count')})")
    if host.get("xla_flags"):
        print(f"xla_flags:   {host['xla_flags']}")
    print(f"mesh:        {m.get('mesh_shape') or 'single device'}")
    print(f"timings:     compile={t.get('compile_s')}s "
          f"execute={t.get('execute_s')}s wall={t.get('wall_s')}s "
          f"lanes={t.get('n_lanes')} lanes/s={t.get('lanes_per_s')}")
    tel = m.get("telemetry") or {}
    if tel.get("samples"):
        print(f"telemetry:   {tel['samples']} samples "
              f"every {tel['every']} quanta, "
              f"{len(tel.get('counters', []))} counters")
    stats = _lane_stats(m)
    if stats:
        print(f"lanes ({len(stats)}):")
        keys = ("cycles", "ipc", "issued", "l1_miss", "l2_miss", "dram_req",
                "lockstep_waste")
        hdr = [k for k in keys if any(k in s for s in stats)]
        print("  lane  " + "  ".join(f"{k:>14}" for k in hdr))
        for i, s in enumerate(stats):
            label = s.get("workload", str(i))
            if "cfg" in s:
                label = f"{label}/{s['cfg']}"
            print(f"  {label:<12}" + "  ".join(
                f"{s.get(k, '-'):>14}" for k in hdr))
    return 0


def render_timeline(manifest: dict, lane: str = "", counters=None,
                    csv: bool = False, cumulative: bool = False,
                    width: int = 64, out=sys.stdout) -> int:
    """Render timelines; returns the number of final-sample/finalize
    mismatches found (0 = invariant holds or not verifiable)."""
    names = _counter_names(manifest)
    tls = _timelines(manifest)
    if not tls:
        print("manifest has no timelines (run with --telemetry S)",
              file=out)
        return 0
    stats = _lane_stats(manifest)
    sel = counters or [c for c in names if c != "cycle"]
    unknown = sorted(set(sel) - set(names))
    if unknown:
        raise SystemExit(f"unknown counter(s) {unknown}; "
                         f"manifest has {names}")
    mismatches = 0
    for li, (key, rows) in enumerate(tls.items()):
        if lane and key != lane:
            continue
        if csv:
            print("lane,sample," + ",".join(names), file=out)
            for si, row in enumerate(rows):
                print(f"{key},{si}," + ",".join(str(v) for v in row),
                      file=out)
            continue
        print(f"lane {key}: {len(rows)} samples", file=out)
        cyc = [r[names.index("cycle")] for r in rows]
        if cyc:
            print(f"  {'cycle':>14} {cyc[0]} .. {cyc[-1]}", file=out)
        for cname in sel:
            ci = names.index(cname)
            series = [r[ci] for r in rows]
            shown = series if cumulative else _deltas(series)
            print(f"  {cname:>14} {spark(shown, width)}  "
                  f"final={series[-1] if series else '-'}", file=out)
        # verify: last sample of every cumulative counter == finalize total
        if li < len(stats) and rows:
            last = rows[-1]
            bad = [c for c in FINAL_MATCH
                   if c in names and c in stats[li]
                   and last[names.index(c)] != stats[li][c]]
            if bad:
                mismatches += len(bad)
                print(f"  MISMATCH vs finalize(): {bad}", file=out)
            else:
                print("  final sample == finalize() totals ✓", file=out)
    return mismatches


def cmd_timeline(args) -> int:
    m = load(args.manifest)
    counters = ([c for c in args.counters.split(",") if c]
                if args.counters else None)
    bad = render_timeline(m, lane=args.lane, counters=counters,
                          csv=args.csv, cumulative=args.cumulative,
                          width=args.width)
    return 1 if bad else 0


def diff_stats(a: dict, b: dict) -> list:
    """[(lane_key, counter, a_val, b_val)] over the comparable() subset of
    two manifests' per-lane stats, lanes matched by (workload, cfg) when
    labeled, by position otherwise."""
    def lane_map(m):
        out = {}
        for i, s in enumerate(_lane_stats(m)):
            key = (s.get("workload", ""), s.get("cfg", i))
            out[key if key != ("", i) else i] = s
        return out

    la, lb = lane_map(a), lane_map(b)
    diffs = []
    for key in la:
        if key not in lb:
            diffs.append((str(key), "<lane missing in B>", "-", "-"))
            continue
        sa, sb = la[key], lb[key]
        try:
            ca, cb = comparable(sa), comparable(sb)
        except KeyError:            # partial stats: fall back to shared keys
            shared = sorted(set(sa) & set(sb))
            ca = {k: sa[k] for k in shared}
            cb = {k: sb[k] for k in shared}
        for k in ca:
            if ca[k] != cb.get(k):
                diffs.append((str(key), k, ca[k], cb.get(k)))
    for key in lb:
        if key not in la:
            diffs.append((str(key), "<lane missing in A>", "-", "-"))
    return diffs


def cmd_diff(args) -> int:
    a, b = load(args.a), load(args.b)
    ta = (a.get("timings") or {})
    tb = (b.get("timings") or {})
    print(f"A: {os.path.basename(args.a)} sha={a.get('git_sha', '?')[:10]} "
          f"lanes/s={ta.get('lanes_per_s')}")
    print(f"B: {os.path.basename(args.b)} sha={b.get('git_sha', '?')[:10]} "
          f"lanes/s={tb.get('lanes_per_s')}")
    if ta.get("lanes_per_s") and tb.get("lanes_per_s"):
        r = tb["lanes_per_s"] / max(ta["lanes_per_s"], 1e-9)
        print(f"throughput:  B/A = {r:.2f}x")
    diffs = diff_stats(a, b)
    if not diffs:
        print("stats: IDENTICAL on the comparable() subset")
        return 0
    print(f"stats: {len(diffs)} comparable() difference(s):")
    for lane, key, va, vb in diffs:
        print(f"  lane {lane:<16} {key:<14} A={va} B={vb}")
    return 1 if args.strict else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.report")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list manifests in a runs dir")
    p.add_argument("dir", nargs="?", default="")

    p = sub.add_parser("summarize", help="one-screen manifest summary")
    p.add_argument("manifest")

    p = sub.add_parser("timeline",
                       help="render sampled counter timelines")
    p.add_argument("manifest")
    p.add_argument("--lane", default="",
                   help="render one lane only (key as shown in the "
                        "manifest: '0', 'mixed/1', ...)")
    p.add_argument("--counters", default="",
                   help="comma-separated counter subset")
    p.add_argument("--csv", action="store_true",
                   help="emit CSV rows instead of sparklines")
    p.add_argument("--cumulative", action="store_true",
                   help="plot cumulative values instead of per-sample "
                        "deltas")
    p.add_argument("--width", type=int, default=64)

    p = sub.add_parser("diff", help="diff two runs' comparable() stats")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 when stats differ")

    args = ap.parse_args(argv)
    return {"list": cmd_list, "summarize": cmd_summarize,
            "timeline": cmd_timeline, "diff": cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:     # e.g. `report timeline --csv | head`
        sys.exit(0)

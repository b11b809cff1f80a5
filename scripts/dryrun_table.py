"""Print the dry run's records (``experiments/dryrun_torch/``, written by
``python -m repro_torch.launch.dryrun``) as a markdown table: per cell
the peak GiB of its busiest device, the dominant roofline term, the
roofline fraction and the trace seconds; skipped and failed cells by
name.  Usage: python scripts/dryrun_table.py [DIR]
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(d=os.path.join(ROOT, "experiments", "dryrun_torch")):
    recs = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                recs.append(json.load(fh))
    print("| arch | shape | mesh | peak GiB a device | dominant | "
          "roofline_fraction | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for r in recs:
        if r.get("skipped") or "error" in r:
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
              f"{r['peak_bytes_per_dev'] / 2**30:.2f} | {r['dominant']} | "
              f"{r['roofline_fraction']:.3e} | {r['lower_s']} |")
    for r in recs:
        if r.get("skipped"):
            print(f"skipped: {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r['reason']}")
        elif "error" in r:
            print(f"failed: {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r['error']}")


if __name__ == "__main__":
    main(*sys.argv[1:])

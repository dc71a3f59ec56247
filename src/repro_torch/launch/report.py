"""The dry-run, roofline and perf tables from the JSON that
``launch/dryrun.py`` and ``launch/perf.py`` write; the production mesh
cells (one rank's step traced in a meta world: the LM cells and the
bwt_index build and serve) and the perf variants' per-rank estimates also
with their collective term.

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dryrun build/dryrun] [--perf build/perf]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .roofline import HBM_BYTES

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DRYRUN_DIR = os.path.join(_ROOT, "build", "dryrun")
PERF_DIR = os.path.join(_ROOT, "build", "perf")


def load_cells(out_dir=DRYRUN_DIR):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _fits(mem) -> str:
    return "yes" if mem["total_bytes"] <= HBM_BYTES else "**NO**"


def dryrun_table(cells):
    rows = ["| arch | shape | mesh | status | arguments | temp | total | "
            "fits 80 GB | trace |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        status = c["status"]
        if status == "skipped":
            status = f"skipped ({c['reason'][:40]}...)"
        mem = c.get("memory")
        if mem:
            cols = (fmt_bytes(mem["argument_size_in_bytes"]),
                    fmt_bytes(mem["temp_size_in_bytes"]),
                    fmt_bytes(mem["total_bytes"]), _fits(mem),
                    f"{c.get('trace_s', 0):.1f}s")
        elif c.get("peak_bytes") is not None:      # a measured index cell
            cols = ("-", "-", f"{fmt_bytes(c['peak_bytes'])} (peak)",
                    "yes" if c["peak_bytes"] <= HBM_BYTES else "**NO**",
                    f"{c['seconds']:.3f}s run")
        else:
            cols = ("-",) * 5
        rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                    f"{status} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def roofline_table(cells):
    rows = [
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "bottleneck | MODEL/counted flops | step s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("status") not in ("traced", "measured"):
            continue
        r = c.get("roofline", {})
        ratio = r.get("useful_flops_ratio")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{r.get('compute_s', 0):.4f} | {r.get('memory_s', 0):.4f} | "
            f"{r.get('collective_s', 0):.4f} | **{r.get('bottleneck')}** | "
            + (f"{ratio:.2f}" if ratio is not None else "-")
            + f" | {r.get('step_time_s', 0):.3f} |")
    return "\n".join(rows)


def mesh_table(cells):
    """The production mesh cells (the LM cells and the bwt_index cells):
    one rank's memory, the bytes its collectives move and the three terms
    of the roofline; a build's traced rounds beside its shape."""
    rows = ["| arch | shape | mesh | rank | arguments | temp | total | "
            "fits 80 GB | collectives moved | compute s | memory s | "
            "collective s | bottleneck |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("chips", 1) == 1 or c.get("status") != "traced":
            continue
        mem, r = c["memory"], c["roofline"]
        shape = c["shape"]
        if "rounds_traced" in c:
            shape += f" ({c['rounds_traced']} rounds)"
        rows.append(
            f"| {c['arch']} | {shape} | {c['mesh']} | {c['rank']} | "
            f"{fmt_bytes(mem['argument_size_in_bytes'])} | "
            f"{fmt_bytes(mem['temp_size_in_bytes'])} | "
            f"{fmt_bytes(mem['total_bytes'])} | {_fits(mem)} | "
            f"{fmt_bytes(c['collectives']['moved_bytes'])} | "
            f"{r['compute_s']:.4g} | {r['memory_s']:.4g} | "
            f"{r['collective_s']:.4g} | **{r['bottleneck']}** |")
    return "\n".join(rows)


def _per_rank(r):
    """A perf variant's per-rank mesh estimate, if it has one."""
    if "mesh_estimate" in r:
        return r["mesh_estimate"]
    return r.get("estimate") if "mesh" in r else None


def perf_table(runs):
    rows = ["| target | variant | status | estimate | measured peak | "
            "peak / estimate | measured s | bound s | bound share | "
            "16x16 rank total | rank collective s |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in runs:
        est = r.get("estimate", {}).get("memory", {}).get("total_bytes")
        peak, s, bound = (r.get("peak_bytes"), r.get("measured_s"),
                          r.get("bound_s"))
        ratio = f"{peak / est:.3f}" if peak and est else "-"
        share = f"{bound / s:.3f}" if bound and s else "-"
        mesh = _per_rank(r)
        rank = ((fmt_bytes(mesh["memory"]["total_bytes"]),
                 f"{mesh['roofline']['collective_s']:.4f}")
                if mesh else ("-", "-"))
        if "mesh" in r:                # the estimate is the rank's
            est = None
        rows.append(
            f"| {r['target']} | {r['variant']} | {r['status']} | "
            f"{fmt_bytes(est)} | {fmt_bytes(peak)} | {ratio} | "
            + (f"{s:.4f}" if s is not None else "-") + " | "
            + (f"{bound:.4f}" if bound is not None else "-")
            + f" | {share} | {rank[0]} | {rank[1]} |")
    return "\n".join(rows)


def summarize(cells):
    n = {"traced": 0, "measured": 0, "skipped": 0, "failed": 0}
    for c in cells:
        n[c.get("status", "failed")] = n.get(c.get("status", "failed"), 0) + 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", default=DRYRUN_DIR)
    ap.add_argument("--perf", default=PERF_DIR)
    args = ap.parse_args(argv)
    cells = load_cells(args.dryrun)
    print("## Dry-run matrix\n")
    print(dryrun_table(cells))
    print("\n## Roofline terms\n")
    print(roofline_table(cells))
    if any(c.get("chips", 1) > 1 for c in cells):
        print("\n## Production mesh cells, per rank\n")
        print(mesh_table(cells))
    print("\n## Perf variants\n")
    print(perf_table(load_cells(args.perf)))
    print("\nsummary:", summarize(cells))


if __name__ == "__main__":
    main()

"""Render the roofline and dry-run tables from ``launch.dryrun``'s JSON
files (the reference's ``launch/report.py``), plus the cells measured on
the card by ``roofline.trace`` (``*.trace.json`` in the same folder).

The dry-run figures are computed from shapes on fake tensors, and their
bounds are against the H100 SXM's published peaks at 700 W
(``roofline.hw``); the measured table is what a card ran.

  python -m repro_torch.launch.report results/dryrun [results/roofline]
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(out_dir: str):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if f.endswith(".trace.json"):
            continue
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def load_traces(out_dir: str):
    out = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.trace.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(x):
    if x is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}EB"


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(cells, mesh_filter="single_pod_16x16",
                   comm="baseline") -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bound | "
        "useful/counted | roofline frac | peak/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c.get("ok") or c.get("mesh") != mesh_filter:
            continue
        if c.get("comm", "baseline") != comm:
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"**{r['dominant'][:4]}** | {r['useful_flops_fraction']:.3f} | "
            f"{r['roofline_fraction']:.4f} | "
            f"{fmt_bytes(r.get('peak_memory_per_device'))} | "
            f"{'yes' if c.get('fits') else '**no**'} |")
    return "\n".join(rows)


def dryrun_table(cells, comm="baseline") -> str:
    rows = [
        "| arch | shape | mesh | count | args/dev | peak/dev | "
        "coll bytes/dev | dominant coll | rules differ |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c.get("ok") or c.get("comm", "baseline") != comm:
            continue
        r = c["roofline"]
        mem = c.get("memory", {})
        br = r.get("coll_breakdown") or {}
        top = max(br, key=br.get) if br else "-"
        mesh_short = "2x16x16" if "multi" in c["mesh"] else "16x16"
        differ = "; ".join(d.split(":")[0] for d in c.get("rules_differ", []))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {mesh_short} | "
            f"{c.get('count_s', '-')}s | "
            f"{fmt_bytes(mem.get('argument_size_in_bytes'))} | "
            f"{fmt_bytes(mem.get('peak_bytes'))} | "
            f"{fmt_bytes(r['coll_bytes_per_device'])} | {top} | "
            f"{differ or '-'} |")
    return "\n".join(rows)


def failures(cells) -> str:
    rows = []
    for c in cells:
        if c.get("ok"):
            continue
        err = (c.get("error") or "").strip().splitlines()
        rows.append(f"- {c['arch']} {c['shape']} ({c.get('comm')}): "
                    f"{err[-1] if err else 'no error text'}")
    return "\n".join(rows) or "- none"


def measured_table(traces) -> str:
    """The cells profiled on the card (``roofline.trace``): each class's
    device ms beside its bound, the idle share and the step's mfu."""
    rows = ["| cell | card | class | launches | device ms | bound ms |",
            "|---|---|---|---|---|---|"]
    for t in traces:
        head = f"{t['cell']} | {t.get('card', '-')}"
        for cls, v in t["classes"].items():
            if not v["launches"]:
                continue
            bound = v.get("bound_ms")
            rows.append(f"| {head} | {cls} | {v['launches']} | "
                        f"{v['ms']:.3f} | "
                        f"{'-' if bound is None else f'{bound:.3f}'} |")
        rows.append(f"| {head} | step: wall {t['wall_ms']:.3f} ms, idle "
                    f"share {t['idle_share']:.3f}, mfu {t['mfu']:.4f} | | | |")
    return "\n".join(rows)


def summary(cells) -> str:
    n_ok = sum(1 for c in cells if c.get("ok"))
    per_mesh = {}
    for c in cells:
        key = (c.get("mesh"), bool(c.get("ok")))
        per_mesh[key] = per_mesh.get(key, 0) + 1
    n_fit = sum(1 for c in cells if c.get("ok") and not c.get("fits"))
    return (f"{n_ok}/{len(cells)} cells counted ({n_fit} do not fit 80 GB). "
            + "; ".join(f"{m}: {'ok' if ok else 'FAIL'}x{n}"
                        for (m, ok), n in sorted(per_mesh.items())))


def main(out_dir: str, trace_dir: str = None):
    cells = load(out_dir)
    print(summary(cells))
    print("\nComputed from shapes, CPU, fake 16 x 16 world; bounds against "
          "H100 SXM peaks at 700 W.")
    for comm in sorted({c.get("comm", "baseline") for c in cells}):
        print(f"\n## Roofline (single pod, {comm})\n")
        print(roofline_table(cells, comm=comm))
        print(f"\n## Dry-run ({comm})\n")
        print(dryrun_table(cells, comm=comm))
    print("\n## Failed cells\n")
    print(failures(cells))
    traces = load_traces(trace_dir or out_dir)
    if traces:
        print("\n## Measured on the card\n")
        print(measured_table(traces))


if __name__ == "__main__":
    main(*(sys.argv[1:] or ["results/dryrun"]))

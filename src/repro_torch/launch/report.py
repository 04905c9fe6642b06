"""Render roofline tables from result JSONs (port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report results.json [...]

Each file holds a list of results as ``launch/roofline.py --json`` writes
them; a result with ``skipped`` or ``error`` renders as such a row.
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x is None:
        return "-"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1.0:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def table(results):
    hdr = ("| cell | plan | HBM/dev (args+temp) | t_compute | t_memory | "
           "t_collective | dominant | roofline frac | MODEL/HLO flops |")
    sep = "|" + "---|" * 9
    rows = [hdr, sep]
    for r in sorted(results, key=lambda x: x.get("label", "")):
        label = r.get("label", "?")
        if "skipped" in r:
            rows.append(f"| {label} | — | — | — | — | — | skipped | — | — |")
            continue
        if "error" in r:
            rows.append(f"| {label} | — | ERROR: {r['error'][:60]} "
                        f"| — | — | — | — | — | — |")
            continue
        p = r.get("plan", {})
        plan = (f"cl={'x'.join(p.get('client_axes') or ['seq'])}"
                f"({p.get('n_clients')}x{p.get('client_groups')}g)")
        mem = (r.get("argument_size_in_bytes") or 0) + \
              (r.get("temp_size_in_bytes") or 0)
        rows.append(
            f"| {label} | {plan} | {fmt_bytes(mem)} "
            f"| {fmt_s(r.get('t_compute_s'))} | {fmt_s(r.get('t_memory_s'))} "
            f"| {fmt_s(r.get('t_collective_s'))} | {r.get('dominant')} "
            f"| {r.get('roofline_fraction')} | {r.get('useful_ratio')} |")
    return "\n".join(rows)


def main():
    for path in sys.argv[1:]:
        with open(path) as f:
            results = json.load(f)
        print(f"\n### {path} ({len(results)} cells)\n")
        print(table(results))


if __name__ == "__main__":
    main()

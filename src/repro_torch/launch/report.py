"""Format the dry-run's records (``launch/dryrun``) into markdown tables.

The counterpart of ``repro/launch/report.py``: the same three tables from
the same records, with the H100's constants in the roofline heading
(``launch/roofline``) and the fits column against the card's 80 GB.

  PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json
"""

from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b / 1e9:.2f}GB"


def fmt_s(s):
    if s >= 1:
        return f"{s:.2f}s"
    return f"{s * 1e3:.1f}ms"


def dryrun_table(results):
    rows = ["| arch | shape | mesh | devices | compile | peak/dev | fits 80GB |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | - | "
                        f"ERROR | - | - |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['n_devices']} "
            f"| {r['compile_s']}s | {fmt_bytes(r['peak_bytes_per_dev'])} "
            f"| {'yes' if r['fits_80gb_hbm'] else 'NO'} |")
    return "\n".join(rows)


def roofline_table(results):
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "MODEL_FLOPS | useful ratio |",
            "|---|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        if r["mesh"] != "single":          # roofline table is single-pod
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rl['compute_s'])} "
            f"| {fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} "
            f"| **{rl['dominant']}** | {rl['model_flops']:.2e} "
            f"| {rl['useful_flops_ratio']:.2f} |")
    return "\n".join(rows)


def wire_breakdown(results):
    rows = ["| arch | shape | all-gather | all-reduce | reduce-scatter | "
            "all-to-all | permute |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(results, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        if r["mesh"] != "single":
            continue
        w = r["roofline"]["wire_by_kind"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_bytes(w['all-gather'])} "
            f"| {fmt_bytes(w['all-reduce'])} "
            f"| {fmt_bytes(w['reduce-scatter'])} "
            f"| {fmt_bytes(w['all-to-all'])} "
            f"| {fmt_bytes(w['collective-permute'])} |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"
    results = json.load(open(path))
    n_ok = sum(r.get("status") == "ok" for r in results)
    print(f"### Dry-run ({n_ok}/{len(results)} combos ok)\n")
    print(dryrun_table(results))
    print("\n### Roofline (single-pod, per device, H100 SXM constants)\n")
    print(roofline_table(results))
    print("\n### Collective wire bytes per device (single-pod)\n")
    print(wire_breakdown(results))


if __name__ == "__main__":
    main()

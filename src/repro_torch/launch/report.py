"""Dry-run and roofline tables from the port's dry-run records (runs/dryrun/*.json).

    PYTHONPATH=src python -m repro_torch.launch.report --dir runs/dryrun

The port's own copy of ``repro.launch.report`` (standard library only): the
same ``load``, ``dryrun_table``, ``roofline_table`` and ``dominant_hint``
over the records of :mod:`repro_torch.launch.dryrun`, which are PLAR's
alone (the LM cells, and their rows and hints, come with ROADMAP §1 item
8 (d)).  The hints name the GPU's hardware (NVLink, HBM, the CUDA cores),
where JAX's name the TPU's; a modelled record's compile time (``null``)
prints as ``—``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

GB = 1024 ** 3


def load(dir_: str) -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_s(v):
    if v is None:
        return "—"
    if v >= 1:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v*1e3:.1f}ms"
    return f"{v*1e6:.0f}µs"


def dryrun_table(records: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | compile | HBM/dev (args+out+temp) | flops/dev | wire B/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**ERROR** | — | — | — | — |")
            continue
        m = r["memory_per_device"]
        hbm = m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"]
        wire = r["collectives"]["total_wire_bytes"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_s(r.get('compile_s'))} | {hbm/GB:.1f} GiB | "
            f"{r['flops_per_device']/1e12:.2f}T | {wire/1e9:.2f} GB |"
        )
    return "\n".join(lines)


def roofline_table(records: List[Dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | model TF | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        rf = r["roofline"]
        mf = r["model_flops_total"] / 1e12
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {mf:.0f} | {dominant_hint(r)} |"
        )
    return "\n".join(lines)


def dominant_hint(r: Dict) -> str:
    dom = r["roofline"]["dominant"]
    if dom == "collective":
        return ("the contingency all-reduce over NVLink: reduce_scatter (θ is "
                "row-separable) or the fused schedule's O(nc) payload")
    if dom == "memory":
        return ("HBM traffic of the column gather and the contingency round trip: "
                "int8 tables, the fused-pack (sweep) formulation")
    return "f32 CUDA-core work of the θ epilogue: fewer bins (the §5.3 ladder)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun")
    ap.add_argument("--what", default="all", choices=["all", "dryrun", "roofline"])
    args = ap.parse_args()
    records = load(args.dir)
    print(f"<!-- {len(records)} records from {args.dir} -->\n")
    if args.what in ("all", "dryrun"):
        print("## §Dry-run (both meshes)\n")
        print(dryrun_table(records))
        print()
    if args.what in ("all", "roofline"):
        print("## §Roofline (single-pod, 256 positions)\n")
        print(roofline_table(records, "single"))
        print("\n### multi-pod (512 positions)\n")
        print(roofline_table(records, "multi"))


if __name__ == "__main__":
    main()

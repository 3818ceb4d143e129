"""Dry-run and roofline tables from the port's dry-run records (runs/dryrun/*.json).

    PYTHONPATH=src python -m repro_torch.launch.report --dir runs/dryrun

The port's own copy of ``repro.launch.report`` (standard library only): the
same ``load``, ``dryrun_table``, ``roofline_table`` (with its useful-FLOPs
column) and ``dominant_hint`` over the records of
:mod:`repro_torch.launch.dryrun`: the LM cells and PLAR's.  The hints name
the GPU's hardware (NVLink, HBM, the tensor and CUDA cores), where JAX's
name the TPU's; a modelled record's compile time (``null``) prints as
``—``.
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
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"skipped¹ | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**ERROR** | — | — | — | — |")
            continue
        m = r.get("memory_per_device", {})
        hbm = (m.get("argument_bytes", 0) + m.get("output_bytes", 0)
               + m.get("temp_bytes", 0) - m.get("alias_bytes", 0))
        wire = (r.get("collectives", {}) or {}).get("total_wire_bytes_per_device")
        if wire is None:
            wire = (r.get("collectives", {}) or {}).get("total_wire_bytes")
        flops = r.get("flops_per_device")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{fmt_s(r.get('compile_s'))} | {hbm/GB:.1f} GiB | "
            f"{(flops or 0)/1e12:.2f}T | {(wire or 0)/1e9:.2f} GB |"
        )
    lines.append("")
    lines.append("¹ long_500k on full-attention archs — skipped per DESIGN.md §4.")
    return "\n".join(lines)


def roofline_table(records: List[Dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | model TF | useful % | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        rf = r.get("roofline")
        if not rf:
            continue
        ratio = r.get("useful_flops_ratio")
        mf = r.get("model_flops_total", 0) / 1e12
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {mf:.0f} | "
            f"{'' if ratio is None else f'{ratio*100:.0f}%'} | {dominant_hint(r)} |"
        )
    return "\n".join(lines)


def dominant_hint(r: Dict) -> str:
    dom = r.get("roofline", {}).get("dominant")
    shape = r.get("shape", "")
    if r.get("arch") == "plar-sdss":
        if dom == "collective":
            return ("the contingency all-reduce over NVLink: reduce_scatter (θ is "
                    "row-separable) or the fused schedule's O(nc) payload")
        if dom == "memory":
            return ("HBM traffic of the column gather and the contingency round trip: "
                    "int8 tables, the fused-pack (sweep) formulation")
        return "f32 CUDA-core work of the θ epilogue: fewer bins (the §5.3 ladder)"
    if dom == "collective":
        return ("smaller FSDP all-gathers over NVLink (DP-only for small models) / "
                "overlap collectives with compute")
    if dom == "memory":
        if "decode" in shape or "long" in shape:
            return "KV-cache quantization / a larger decode batch amortizes the HBM weight reads"
        if "train" in shape:
            return ("a flash backward kernel (the plain backward writes the S² scores to "
                    "HBM) / fused remat")
        return "fused norms, RoPE and casts (eager PyTorch writes every op's output to HBM)"
    return "causal block skipping in prefill / wgmma-aligned tiles on the tensor cores"


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

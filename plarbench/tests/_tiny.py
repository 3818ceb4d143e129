"""A benchmark tree at a size a CPU test can hold: a copy of ``plarbench/``
with a small configuration and its two cells added as files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"name": "tiny", "rows": 20000, "attrs": 12, "n_dec": 3, "v_max": 4,
        "distinct_fraction": 0.1}


def tiny_config(**over) -> dict:
    cfg = json.loads((REPO / "plarbench" / "configs" / "kdd99.json").read_text())
    cfg.update(TINY, **over)
    return cfg


def make_tree(root: Path, delta: str = "SCE") -> Path:
    """``root`` holding BENCHMARK.json and plarbench/, with cells
    ``tiny.batch`` and ``tiny.stream`` of the configuration ``tiny``."""
    shutil.copytree(REPO / "plarbench", root / "plarbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = tiny_config()
    cfg["run"] = {**cfg["run"], "delta": delta}
    (root / "plarbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for kind in ("batch", "stream"):
        w = json.loads((REPO / "plarbench" / "workloads" / f"kdd99.{kind}.json").read_text())
        w["config"] = "tiny"
        (root / "plarbench" / "workloads" / f"tiny.{kind}.json").write_text(json.dumps(w))
        bench["workloads"].append({"name": f"tiny.{kind}", "config": "tiny", "traffic": kind,
                                   "chips": 1, "why": "a CPU test's size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("kdd99", "tiny") for w in m["workloads"]
                               if w.startswith("kdd99")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

"""What the port's bench modules (``bench_serve``, ``bench_chaos``,
``bench_obs``, ``bench_ingest``) share: the card's line, the wall-clock
bounds and the command line.

Each bench keeps the JAX benchmark's correctness guarantees as assertions
inside its section functions (the tests call them at a smoke size on the
CPU) and its wall-clock ratios as :class:`Bound`\\ s, checked by the command
line only: ``python -m repro_torch.launch.bench_<name> [--device cuda|cpu]
[--section NAME ...]`` prints the card's name and power limit on its first
line, then one JSON row a line, and exits 1 when a ratio misses its bound.
The bounds were set on a CPU for the JAX package; ``chip_smoke.py`` prints
each ratio beside its bound without failing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["Bound", "card_line", "check_bounds", "main"]


@dataclasses.dataclass(frozen=True)
class Bound:
    """A wall-clock ratio's bound: ``key`` of the section's rows ``op`` value."""

    section: str
    key: str
    op: str            # ">=" or "<"
    value: float

    def met(self, x: float) -> bool:
        return x >= self.value if self.op == ">=" else x < self.value


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s first line, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: none ({type(e).__name__})"
    line = r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    return f"card: {line}" if r.returncode == 0 and line else "card: none"


def check_bounds(bounds: Sequence[Bound], results: Dict[str, List[Dict]]) -> List[Dict]:
    """One row a bound whose section ran: its ratio, the bound and
    ``bound_met``."""
    out = []
    for b in bounds:
        if b.section not in results:
            continue
        vals = [r[b.key] for r in results[b.section] if isinstance(r.get(b.key), (int, float))]
        for v in vals:
            out.append({"section": b.section, "ratio": b.key, "value": v,
                        "bound": f"{b.op} {b.value}", "bound_met": b.met(v)})
    return out


def main(name: str, sections: Dict[str, Callable[..., List[Dict]]], bounds: Sequence[Bound],
         argv: Optional[Sequence[str]] = None,
         default: Optional[Sequence[str]] = None) -> Dict[str, List[Dict]]:
    """The bench's command line: ``default`` names the sections run without
    ``--section`` (all of them when ``None``)."""
    ap = argparse.ArgumentParser(prog=f"python -m repro_torch.launch.{name}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--section", action="append", choices=sorted(sections),
                    help="run only these sections (default: all)")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    results = {}
    for sec in args.section or list(default or sections):
        rows = sections[sec](device=args.device)
        results[sec] = rows
        for r in rows:
            print(json.dumps({"section": sec, **r}, default=str), flush=True)
    checks = check_bounds(bounds, results)
    for c in checks:
        print(json.dumps(c), flush=True)
    missed = [c for c in checks if not c["bound_met"]]
    if missed:
        print(f"{name}: {len(missed)} wall-clock bound(s) missed: "
              + ", ".join(f"{c['section']}.{c['ratio']}={c['value']} ({c['bound']})"
                          for c in missed), file=sys.stderr)
        sys.exit(1)
    return results

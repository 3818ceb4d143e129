"""Distributed PLAR of the PyTorch port on a mesh of ranks (the paper's cluster).

    PYTHONPATH=src python examples/pt_distributed_reduction.py               # NCCL, mesh 1,1
    PYTHONPATH=src python examples/pt_distributed_reduction.py --device cpu  # 8 gloo ranks

Runs the mesh-distributed MDP implementation (granules over 'data',
candidates over 'model') with one ``torch.distributed`` rank a mesh position,
spawned here: NCCL ranks on the card, one card a rank (mesh 1,1 by default),
or gloo ranks on the CPU (mesh 4,2 by default).  Each collective schedule (paper-faithful
all_reduce, beyond-paper reduce_scatter and fused; DESIGN.md §3.2) must give
the reduct of single-process ``plar_reduce`` and of the brute-force oracle
(``repro_torch.core.oracle``).  The counterpart of
``examples/distributed_reduction.py``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import time

DELTAS = ("PR", "SCE")
COLLECTIVES = ("all_reduce", "reduce_scatter", "fused")


def table(rows: int):
    from repro_torch.data import scaled_paper_dataset

    return scaled_paper_dataset("shuttle", max_rows=rows, max_attrs=9).table()


def rank_main(device, shape, rows, want) -> None:
    """One rank: every measure and schedule; rank 0 prints."""
    import torch.distributed as dist

    from repro_torch.core.distributed import plar_reduce_distributed
    from repro_torch.distributed import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device=device)
    x, d = table(rows)
    if dist.get_rank() == 0:
        print(f"mesh: {mesh.shape} over {dist.get_world_size()} {device.type} ranks; "
              f"table: {x.shape}", flush=True)
    for delta in DELTAS:
        for coll in COLLECTIVES:
            t0 = time.perf_counter()
            r = plar_reduce_distributed(x, d, mesh, delta=delta, collective=coll)
            dt = time.perf_counter() - t0
            if dist.get_rank() == 0:
                match = "==" if r.reduct == want[delta] else "!="
                print(f"Δ={delta:<4} {coll:<15} reduct={r.reduct} {match} serial and "
                      f"oracle ({dt:.2f}s)", flush=True)
            if r.reduct != want[delta]:
                raise AssertionError(f"{delta}/{coll}: {r.reduct} != {want[delta]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh", default=None, help="data,model (default 4,2 on cpu, 1,1 on cuda)")
    ap.add_argument("--rows", type=int, default=20000)
    args = ap.parse_args()
    shape = tuple(int(v) for v in (args.mesh or ("4,2" if args.device == "cpu" else "1,1"))
                  .split(","))

    from repro_torch.core import plar_reduce
    from repro_torch.core.oracle import reduct_oracle
    from repro_torch.distributed import spawn

    x, d = table(args.rows)
    want = {}
    for delta in DELTAS:
        serial = plar_reduce(x, d, delta=delta, device=args.device).reduct
        oracle = reduct_oracle(delta, x, d)
        assert serial == oracle, (delta, serial, oracle)
        want[delta] = serial
    spawn(rank_main, shape[0] * shape[1], (shape, args.rows, want), device=args.device)


if __name__ == "__main__":
    main()

"""Attribute-reduction launcher of the PyTorch port (the paper's CLI):

    python -m repro_torch.launch.reduce --dataset mushroom --delta SCE
    python -m repro_torch.launch.reduce --dataset kdd99 --max-rows 5000000 --backend sweep
    python -m repro_torch.launch.reduce --dataset mushroom --device cpu

    python -m repro_torch.launch.reduce --dataset mushroom --delta SCE \
        --distributed --mesh 4,2 --collective fused --max-rows 2000 --device cpu

The flags of ``repro.launch.reduce``, plus ``--device {cuda,cpu}`` (default
``cuda``: no card is an error, never a silent CPU run).  ``--ensemble
MEASURES|all`` (with ``--bags N``) runs the measure grid as one stacked
engine loop and prints ``"ensemble": [...]``, one entry a config.

``--distributed`` runs the mesh driver (``repro_torch.core.distributed``)
on ``prod(--mesh)`` ranks, one a mesh position, and rank 0 prints.  Under
``torchrun`` (``WORLD_SIZE`` in the environment) this process is one rank;
otherwise the CLI spawns the ranks itself: gloo ranks on ``--device cpu``,
NCCL ranks on ``--device cuda``, one card a rank (a mesh larger than the
visible cards is an error).  On the cards each rank copies only its data
shard's rows to its card and hands them over as its partition
(``plar_reduce_distributed(partition=True)``); on the CPU every rank hands
over the whole table.

``--stream`` runs the dataset at its full Table-5 shape through streaming
GrC ingestion (chunks of ``--chunk-rows``); ``--max-rows``/``--max-attrs``
apply only to the non-streaming path.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.reduce")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--delta", default="SCE", choices=["PR", "SCE", "LCE", "CCE"])
    ap.add_argument("--stream", action="store_true",
                    help="full paper-scale shape via streaming GrC ingestion")
    ap.add_argument("--chunk-rows", type=int, default=65536,
                    help="rows granulated per streaming chunk")
    ap.add_argument("--max-rows", type=int, default=None,
                    help="row cap, non-streaming path only (default 20000)")
    ap.add_argument("--max-attrs", type=int, default=None,
                    help="attribute cap, non-streaming path only (default 64)")
    ap.add_argument("--max-features", type=int, default=None)
    ap.add_argument("--mode", default="incremental", choices=["incremental", "spark"])
    ap.add_argument("--backend", default="segment",
                    choices=["segment", "onehot", "pallas", "fused",
                             "fused_xla", "sweep", "sweep_xla"],
                    help="Θ evaluation backend (pallas/fused/sweep = the CUDA "
                         "contingency / fused-Θ / sweep-Θ kernels on a card)")
    ap.add_argument("--bin-ladder", default="off", choices=["on", "off"],
                    help="K-adaptive bin ladder for the candidate sweep "
                         "(DESIGN.md §5.3)")
    ap.add_argument("--engine", default="auto", choices=["auto", "host", "device"],
                    help="greedy loop: device = the device-resident loop (a "
                         "CUDA graph replayed on a card), host = the host "
                         "loop; auto = device for segment/onehot/fused_xla/"
                         "sweep_xla, host for the kernel backends")
    ap.add_argument("--selector", default="analytic",
                    choices=["heuristic", "analytic", "pinned"],
                    help="the CUDA kernels' launch shape and the ladder's rungs: "
                         "analytic = the Hopper cost model (a tuning persisted in "
                         "$REPRO_TORCH_AUTOTUNE_CACHE wins), heuristic = a shape "
                         "rule, pinned = the kernels' earlier fixed tiles")
    ap.add_argument("--shrink", action="store_true",
                    help="FSPA universe shrinking (drop pure classes)")
    ap.add_argument("--mp-chunk", type=int, default=64)
    ap.add_argument("--ensemble", default=None, metavar="MEASURES",
                    help="comma-separated measure grid (or 'all' = "
                         "PR,SCE,LCE,CCE) run as ONE stacked engine loop; "
                         "--shrink/--max-features apply to every member")
    ap.add_argument("--bags", type=int, default=None, metavar="N",
                    help="with --ensemble: N bagged (bootstrap-reweighted) "
                         "replicas per measure, seeds 0..N-1")
    ap.add_argument("--no-grc", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="the mesh driver: granules over data shards, candidates "
                         "over model shards, one rank a mesh position")
    ap.add_argument("--mesh", default="4,2", help="data,model (distributed)")
    ap.add_argument("--collective", default="all_reduce",
                    choices=["all_reduce", "reduce_scatter", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; no card is an error)")
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the CLI; prints the result and returns it as a dict."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.stream:
        dropped = [name for name, off_default in [
            ("--max-rows", args.max_rows is not None),
            ("--max-attrs", args.max_attrs is not None),
            ("--no-grc", args.no_grc),
        ] if off_default]
        if dropped:
            ap.error(f"{', '.join(dropped)} not supported with --stream "
                     "(streaming runs the full Table-5 shape under GrC init)")
    if not args.distributed or args.ensemble is not None:
        return _run(ap, args)       # the ensemble branch refuses --distributed

    # the mesh driver has no mode/shrink knobs and only the mesh-capable
    # Θ backends — refuse rather than silently ignoring them
    dropped = [name for name, off_default in [
        ("--mode", args.mode != "incremental"),
        ("--backend", args.backend not in ("segment", "sweep_xla")),
        ("--shrink", args.shrink),
        ("--mp-chunk", args.mp_chunk != 64),
    ] if off_default]
    if dropped:
        ap.error(f"{', '.join(dropped)} not supported with --distributed")
    shape = _mesh_shape(ap, args.mesh)
    if "WORLD_SIZE" in os.environ:          # under torchrun: this process is one rank
        from repro_torch.distributed.api import init_process_group

        import torch.distributed as dist

        dev = init_process_group(args.device)
        try:
            return _run(ap, args, rank_device=dev, mesh_shape=shape)
        finally:
            dist.destroy_process_group()
    return _spawn_world(ap, args, argv, shape)


def _mesh_shape(ap, text: str):
    try:
        shape = tuple(int(v) for v in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        ap.error(f"--mesh takes data,model sizes (e.g. 4,2), got {text!r}")
    return shape


def _spawn_world(ap, args, argv, shape) -> dict:
    """Run this command on ``prod(shape)`` local ranks; rank 0's result."""
    import torch

    from repro_torch.distributed.api import spawn

    world = shape[0] * shape[1]
    if args.device == "cuda":
        n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n_gpus:
            ap.error(f"--mesh {args.mesh} needs {world} ranks, one GPU each (NCCL puts "
                     f"one rank on one card); {n_gpus} GPU(s) visible")
    with tempfile.TemporaryDirectory(prefix="repro_torch_reduce_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        spawn(_cli_rank, world, (argv, out_path), device=args.device)
        with open(out_path) as f:
            return json.load(f)


def _cli_rank(device, argv, out_path: str) -> None:
    """One spawned rank of ``--distributed``: rank 0 prints and writes its
    result to ``out_path``."""
    import torch.distributed as dist

    ap = _parser()
    args = ap.parse_args(argv)
    out = _run(ap, args, rank_device=device, mesh_shape=_mesh_shape(ap, args.mesh))
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def _run(ap, args, *, rank_device=None, mesh_shape=None) -> dict:
    """The CLI's work in this process: one reduction (or one ensemble), or
    this rank's part of a distributed one (``mesh_shape`` set)."""
    from repro_torch.core.engine import ENSEMBLE_BACKENDS
    from repro_torch.core.reduction import (
        _resolve_engine,
        plar_reduce,
        plar_reduce_ensemble,
        resolve_granularity,
    )
    from repro_torch.data import paper_dataset, scaled_paper_dataset
    from repro_torch.device import resolve_device

    device = resolve_device(args.device if rank_device is None else rank_device)
    if args.stream:
        source = paper_dataset(args.dataset)
        table_shape = [source.n_rows, source.n_attrs]
        x = d = None
    else:
        source = None
        x, d = scaled_paper_dataset(
            args.dataset,
            max_rows=args.max_rows if args.max_rows is not None else 20000,
            max_attrs=args.max_attrs if args.max_attrs is not None else 64,
        ).table()
        table_shape = list(x.shape)

    if mesh_shape is not None:
        return _run_distributed(args, device, mesh_shape, x, d, source, table_shape)

    t0 = time.perf_counter()
    gran = resolve_granularity(x, d, source=source, grc_init=not args.no_grc,
                               chunk_rows=args.chunk_rows, device=device)
    granules = int(gran.num)
    granulate_s = time.perf_counter() - t0

    if args.ensemble is not None:
        dropped = [name for name, off_default in [
            ("--distributed", args.distributed),
            ("--engine", args.engine == "host"),
            ("--backend", args.backend not in ENSEMBLE_BACKENDS),
            ("--delta", args.delta != "SCE"),  # the grid IS the measure knob
        ] if off_default]
        if dropped:
            ap.error(f"{', '.join(dropped)} not supported with --ensemble "
                     f"(stacked engine backends: {', '.join(ENSEMBLE_BACKENDS)}; "
                     f"measures go in the --ensemble list)")
        measures_ = (["PR", "SCE", "LCE", "CCE"] if args.ensemble == "all"
                     else [s.strip() for s in args.ensemble.split(",")])
        configs = [{"delta": dd, "shrink": args.shrink,
                    "max_features": args.max_features} for dd in measures_]
        seeds = None if args.bags is None else list(range(args.bags))
        rs = plar_reduce_ensemble(
            source=gran, configs=configs, seeds=seeds, mode=args.mode,
            backend=args.backend, ladder=args.bin_ladder == "on",
            selector=args.selector, mp_chunk=args.mp_chunk,
            grc_init=not args.no_grc, device=device)
        grid = [{"delta": dd} if seeds is None else {"delta": dd, "seed": s}
                for dd in measures_ for s in (seeds or [None])]
        out = {
            "dataset": args.dataset, "table_shape": table_shape,
            "ensemble": [
                {**g, "reduct": r.reduct, "core": r.core,
                 "theta_full": r.theta_full, "iterations": r.iterations,
                 "elapsed_s": round(r.elapsed_s, 3),
                 "theta_history": r.theta_history}
                for g, r in zip(grid, rs)],
            "device": str(device), "backend": args.backend, "granules": granules,
            "granulate_s": round(granulate_s, 3),
        }
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            print(f"{'dataset':>14}: {out['dataset']}")
            print(f"{'table_shape':>14}: {out['table_shape']}")
            for e in out["ensemble"]:
                tag = e["delta"] + (f"/bag{e['seed']}" if "seed" in e else "")
                print(f"{tag:>14}: reduct={e['reduct']} "
                      f"theta_full={e['theta_full']:.6f}")
        return out
    r = plar_reduce(source=gran, delta=args.delta, mode=args.mode,
                    backend=args.backend, ladder=args.bin_ladder == "on",
                    selector=args.selector, engine=args.engine,
                    shrink=args.shrink, mp_chunk=args.mp_chunk,
                    grc_init=not args.no_grc, max_features=args.max_features,
                    device=device)

    out = {
        "dataset": args.dataset, "delta": args.delta,
        "table_shape": table_shape,
        "reduct": r.reduct, "core": r.core,
        "theta_full": r.theta_full, "iterations": r.iterations,
        "n_evaluations": r.n_evaluations, "elapsed_s": round(r.elapsed_s, 3),
        "device": str(device), "backend": args.backend,
        "engine": _resolve_engine(args.engine, args.backend), "granules": granules,
        "granulate_s": round(granulate_s, 3), "theta_history": r.theta_history,
    }
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for k, v in out.items():
            print(f"{k:>14}: {v}")
    return out


def _run_distributed(args, device, mesh_shape, x, d, source, table_shape) -> dict:
    """This rank's part of ``--distributed``; rank 0 prints."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.distributed import partition_rows, plar_reduce_distributed
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed.api import make_mesh

    mesh = make_mesh(mesh_shape, ("data", "model"), device=device)
    partition = x is not None and device.type == "cuda"
    if partition:       # each card is handed its own rows only (a cached partition)
        lo, hi = partition_rows(x.shape[0], mesh)
        x, d = (torch.from_numpy(a[lo:hi]).to(device) for a in (x, d))
    counter = _MeshColl.bytes_counter()
    bytes0 = counter.value
    r = plar_reduce_distributed(x, d, mesh, partition=partition, source=source,
                                chunk_rows=args.chunk_rows,
                                delta=args.delta, max_features=args.max_features,
                                collective=args.collective, backend=args.backend,
                                ladder=args.bin_ladder == "on", selector=args.selector,
                                grc_init=not args.no_grc, engine=args.engine)
    out = {
        "dataset": args.dataset, "delta": args.delta,
        "table_shape": table_shape,
        "reduct": r.reduct, "core": r.core,
        "theta_full": r.theta_full, "iterations": r.iterations,
        "n_evaluations": r.n_evaluations, "elapsed_s": round(r.elapsed_s, 3),
        "device": device.type, "backend": args.backend, "mesh": dict(mesh.shape),
        "collective": args.collective, "collective_bytes": counter.value - bytes0,
        "theta_history": r.theta_history,
    }
    if dist.get_rank() == 0:
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            for k, v in out.items():
                print(f"{k:>14}: {v}")
    return out


if __name__ == "__main__":
    main()

"""The mesh driver of the port (gloo, 8 CPU ranks) against the JAX package's
(8 fake XLA devices): the host loop, the three collective schedules, the
pod mesh and the ingestion paths.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
as ``tests/test_distributed.py``) writes every reference result, and one
world of 8 gloo ranks (``repro_torch.distributed.spawn``) computes the
port's, both from the case list below on the same seeded tables, at the
same time.  Port against JAX: reducts and cores equal, Θ_PR histories
bit-equal (integer counts, one division), SCE/LCE/CCE within rtol=1e-6,
atol=1e-7 (the JAX test's own tolerance: XLA and PyTorch sum rows in other
orders).  Every rank returns the same result, and the rank processes import
nothing of JAX or ``repro``.  Mirrors ``tests/test_distributed.py:33-161``.

The harness (``_run_worlds``) serves ``test_torch_distributed_engine.py``
too; this module imports nothing of JAX at the top, because the gloo ranks
import it for their target function.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
WORLD = 8
DEADLINE_S = 300          # each world; a stuck collective fails this file, not the suite
DELTAS = ["PR", "SCE", "LCE", "CCE"]
COLLECTIVES = ["all_reduce", "reduce_scatter", "fused"]
MESH = ((4, 2), ("data", "model"))
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
STREAM = dict(n_rows=3000, n_attrs=9, v_max=3, n_dec=2, distinct_fraction=0.2, seed=1)


# --- the seeded tables of tests/test_distributed.py --------------------------


def table(name: str):
    if name.startswith("redundant"):          # redundant:<seed>:<rows>:<attrs>:<vmax>
        _, seed, n, a, vmax = name.split(":")
        rng = np.random.default_rng(int(seed))
        x = rng.integers(0, int(vmax), size=(int(n), int(a))).astype(np.int32)
        for j in range(1, int(a)):
            if rng.random() < 0.4:
                x[:, j] = x[:, rng.integers(0, j)]
        return x, rng.integers(0, 2, size=(int(n),)).astype(np.int32)
    if name == "pod":
        rng = np.random.default_rng(1)
        x = rng.integers(0, 3, size=(200, 6)).astype(np.int32)
        return x, rng.integers(0, 2, size=(200,)).astype(np.int32)
    raise KeyError(name)


ORACLE_TABLE = "redundant:0:300:8:3"

CASES = (
    # oracle agreement, every measure and schedule, on the host loop
    [dict(key=f"oracle/{delta}/{coll}", kind="mesh", mesh=MESH, table=ORACLE_TABLE,
          kw=dict(delta=delta, collective=coll, engine="host"))
     for delta in DELTAS for coll in COLLECTIVES]
    + [dict(key=f"oracle/{delta}", kind="oracle", table=ORACLE_TABLE, kw=dict(delta=delta))
       for delta in DELTAS]
    # no core folded first: one class holds every granule, so the fused
    # schedule's first iterations fall back to all_reduce
    + [dict(key=f"fallback/{delta}", kind="mesh", mesh=MESH, table=ORACLE_TABLE,
            kw=dict(delta=delta, collective="fused", compute_core=False))
       for delta in ("PR", "SCE")]
    # the pod mesh: the data group spans pod × data
    + [dict(key=f"pod/{delta}/{coll}", kind="mesh", mesh=POD_MESH, table="pod",
            kw=dict(delta=delta, collective=coll))
       for delta in ("SCE", "PR") for coll in ("all_reduce", "fused")]
    + [dict(key="pod/SCE", kind="oracle", table="pod", kw=dict(delta="SCE"))]
    # ingestion: arrays, a streamed source, a prebuilt granularity, one process
    + [dict(key=f"source/{delta}/{path}", kind="mesh", mesh=MESH, table=path,
            kw=dict(delta=delta, collective=coll))
       for delta in ("SCE", "PR") for path in ("stream_arrays", "stream", "stream_gran")
       for coll in (("all_reduce", "fused") if path == "stream" else ("all_reduce",))]
    + [dict(key=f"source/{delta}/serial", kind="serial", table="stream_arrays",
            kw=dict(delta=delta)) for delta in ("SCE", "PR")]
)
for _c in CASES:     # one key a case, whatever the collective loop above made of it
    if _c["kind"] == "mesh" and _c["table"] == "stream":
        _c["key"] += "/" + _c["kw"]["collective"]


# --- the two sides -----------------------------------------------------------


def _record(r) -> dict:
    return dict(reduct=r.reduct, core=r.core, theta_history=[float(t) for t in r.theta_history],
                theta_full=float(r.theta_full), iterations=r.iterations)


def _inputs(pkg, case):
    """``(x, d, source)`` of a case for ``pkg`` ("jax" or "torch")."""
    name = case["table"]
    if not name.startswith("stream"):
        x, d = table(name)
        return x, d, None
    if pkg == "jax":
        from repro.core import build_granularity
        from repro.data import TabularStream
    else:
        from repro_torch.core import build_granularity
        from repro_torch.data import TabularStream
    t = TabularStream(**STREAM)
    if name == "stream":
        return None, None, t
    x, d = t.table()
    if name == "stream_arrays":
        return x, d, None
    if pkg == "jax":
        import jax.numpy as jnp
        g = build_granularity(jnp.asarray(x), jnp.asarray(d), n_dec=2, v_max=3)
    else:
        import torch
        g = build_granularity(torch.from_numpy(x), torch.from_numpy(d), n_dec=2, v_max=3)
    return None, None, g


def _jax_main(cases_path: str, out_path: str) -> None:
    """The reference: every case through the JAX package (8 fake devices)."""
    from repro.core import plar_reduce
    from repro.core.distributed import plar_reduce_distributed
    from repro.core.oracle import reduct_oracle
    from repro.distributed.api import make_mesh

    with open(cases_path) as f:
        cases = json.load(f)
    meshes, out = {}, {}
    for case in cases:
        x, d, source = _inputs("jax", case)
        if case["kind"] == "oracle":
            out[case["key"]] = dict(reduct=reduct_oracle(case["kw"]["delta"], x, d))
        elif case["kind"] == "serial":
            out[case["key"]] = _record(plar_reduce(x, d, **case["kw"]))
        else:
            shape, axes = case["mesh"]
            key = (tuple(shape), tuple(axes))
            if key not in meshes:
                meshes[key] = make_mesh(tuple(shape), tuple(axes))
            out[case["key"]] = _record(plar_reduce_distributed(
                x, d, meshes[key], source=source, chunk_rows=512, **case["kw"]))
    with open(out_path, "w") as f:
        json.dump(out, f)


def _port_rank(device, cases, out_dir: str) -> None:
    """One gloo rank: every case through the port; rank r writes
    ``rank{r}.json`` with its results, each device run's bodies and polls,
    and the jax/repro modules it holds (none)."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import distributed as D
    from repro_torch.core import plar_reduce
    from repro_torch.core.distributed import plar_reduce_distributed
    from repro_torch.core.oracle import reduct_oracle
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.mesh import make_host_mesh

    obs.enable()
    budget_bytes = D._device_budget_bytes
    # every rank builds every mesh, in one order, before any case runs
    meshes = {}
    for case in cases:
        if case["kind"] == "mesh":
            key = (tuple(case["mesh"][0]), tuple(case["mesh"][1]))
            if key not in meshes:
                meshes[key] = make_mesh(*key, device=device)
    host = make_host_mesh(device=device)
    rank = dist.get_rank()
    out = {"_host_mesh": [host.shape, host.data_index, host.model_index],
           "_mesh_index": {str(k[0]): [m.data_index, m.model_index] for k, m in meshes.items()}}
    for case in cases:
        x, d, source = _inputs("torch", case)
        if case["kind"] == "oracle":
            if rank == 0:
                out[case["key"]] = dict(reduct=reduct_oracle(case["kw"]["delta"], x, d))
            continue
        if case["kind"] == "serial":
            if rank == 0:
                out[case["key"]] = _record(plar_reduce(x, d, device="cpu", **case["kw"]))
            continue
        mesh = meshes[(tuple(case["mesh"][0]), tuple(case["mesh"][1]))]
        if "budgets" in case:       # this rank's device budget for engine="auto"
            D._device_budget_bytes = lambda dev, b=case["budgets"][rank]: b
        before = obs.get_tracer().recorded
        try:
            r = plar_reduce_distributed(x, d, mesh, source=source, chunk_rows=512, **case["kw"])
        finally:
            D._device_budget_bytes = budget_bytes
        rec = _record(r)
        fresh = obs.get_tracer().recorded - before
        spans = obs.get_tracer().records()[-fresh:] if fresh else []
        engine = [s for s in spans if s.name == "engine.dispatch"]
        if engine:
            rec["bodies"], rec["polls"] = engine[-1].args["bodies"], engine[-1].args["polls"]
        rec["engine_ran"] = "device" if engine else "host"
        loops = [s for s in spans if s.name == "mesh.loop"]
        rec["host_loops"] = len(loops)
        if loops:
            rec["loop_bytes"] = loops[-1].args["collective_bytes"]
        out[case["key"]] = rec
    out["_fused"] = {k: obs.counter(f"plar_mesh_fused_{k}_total").value
                     for k in ("iterations", "fallbacks")}
    out["_modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                             or m == "repro" or m.startswith("repro."))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _port_main(cases_path: str, out_dir: str) -> None:
    from repro_torch.distributed import spawn

    with open(cases_path) as f:
        cases = json.load(f)
    spawn(_port_rank, WORLD, (cases, out_dir), device="cpu", timeout_s=DEADLINE_S - 30)


def _run_worlds(cases, tmp) -> dict:
    """Run the JAX reference and the port's gloo world at once; returns
    ``{"jax": {...}, "ranks": [{...}] * WORLD, "seconds": ...}``."""
    t0 = time.perf_counter()
    cases_path = os.path.join(tmp, "cases.json")
    with open(cases_path, "w") as f:
        json.dump(cases, f)
    jax_out = os.path.join(tmp, "jax.json")
    boot = f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; import test_torch_distributed as H; "
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
               "JAX_PLATFORMS": "cpu"}
    procs = [
        subprocess.Popen([sys.executable, "-c", boot + f"H._jax_main({cases_path!r}, {jax_out!r})"],
                         env=jax_env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True),
        subprocess.Popen([sys.executable, "-c", boot + f"H._port_main({cases_path!r}, {tmp!r})"],
                         env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True),
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(DEADLINE_S - (time.perf_counter() - t0), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p, log in zip(("jax", "port"), procs, logs):
        assert p.returncode == 0, f"{name} world failed:\n{log[-6000:]}"
    with open(jax_out) as f:
        ref = json.load(f)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"jax": ref, "ranks": ranks, "seconds": time.perf_counter() - t0}


def assert_matches_jax(delta, got, want):
    assert got["reduct"] == want["reduct"]
    assert got["core"] == want["core"]
    assert got["iterations"] == want["iterations"]
    if delta == "PR":
        assert got["theta_history"] == want["theta_history"]     # bit-equal floats
        assert got["theta_full"] == want["theta_full"]
    else:
        np.testing.assert_allclose(got["theta_history"], want["theta_history"],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["theta_full"], want["theta_full"], rtol=1e-6, atol=1e-7)


def assert_replicated(ranks, key):
    """Every rank returned the same result (and ran the same bodies)."""
    for r in ranks[1:]:
        assert r[key] == ranks[0][key], key


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _run_worlds(CASES, str(tmp_path_factory.mktemp("worlds")))


# --- the tests ---------------------------------------------------------------


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("coll", COLLECTIVES)
def test_host_loop_matches_jax_and_oracle(worlds, delta, coll):
    key = f"oracle/{delta}/{coll}"
    got, want = worlds["ranks"][0][key], worlds["jax"][key]
    assert_matches_jax(delta, got, want)
    assert got["reduct"] == worlds["ranks"][0][f"oracle/{delta}"]["reduct"]
    assert worlds["ranks"][0][f"oracle/{delta}"] == worlds["jax"][f"oracle/{delta}"]
    assert_replicated(worlds["ranks"], key)
    # one mesh.loop span a host run, with the loop's collective bytes
    assert got["host_loops"] == 1 and got["loop_bytes"] > 0


@pytest.mark.parametrize("delta", ["SCE", "PR"])
@pytest.mark.parametrize("coll", ["all_reduce", "fused"])
def test_pod_mesh_matches_jax(worlds, delta, coll):
    key = f"pod/{delta}/{coll}"
    got = worlds["ranks"][0][key]
    assert_matches_jax(delta, got, worlds["jax"][key])
    if delta == "SCE":
        oracle = worlds["ranks"][0]["pod/SCE"]["reduct"]
        assert got["reduct"] == oracle == worlds["jax"]["pod/SCE"]["reduct"]
    assert_replicated(worlds["ranks"], key)


@pytest.mark.parametrize("delta", ["SCE", "PR"])
def test_sources_match_arrays_and_one_process(worlds, delta):
    """Streaming ``source=`` (each shard folds its slice of every chunk), a
    prebuilt granularity split over the shards, and the array path agree
    with single-process ``plar_reduce`` and with JAX."""
    r0 = worlds["ranks"][0]
    serial = r0[f"source/{delta}/serial"]
    assert_matches_jax(delta, serial, worlds["jax"][f"source/{delta}/serial"])
    keys = [f"source/{delta}/stream_arrays", f"source/{delta}/stream/all_reduce",
            f"source/{delta}/stream/fused", f"source/{delta}/stream_gran"]
    for key in keys:
        assert r0[key]["reduct"] == serial["reduct"], key
        assert_matches_jax(delta, r0[key], worlds["jax"][key])
        assert_replicated(worlds["ranks"], key)


@pytest.mark.parametrize("delta", ["PR", "SCE"])
def test_fused_without_core_matches_jax(worlds, delta):
    key = f"fallback/{delta}"
    assert_matches_jax(delta, worlds["ranks"][0][key], worlds["jax"][key])
    assert_replicated(worlds["ranks"], key)


def test_fused_schedule_ran_and_fell_back(worlds):
    """The fused cases ran the fused partial in some iterations and fell
    back to all_reduce in others (classes too large for a shard early)."""
    for r in worlds["ranks"]:
        assert r["_fused"]["iterations"] > 0 and r["_fused"]["fallbacks"] > 0, r["_fused"]


def test_meshes_lay_ranks_out_row_major(worlds):
    """``make_host_mesh()`` is one data axis over the world; rank r of the
    (4, 2) and (2, 2, 2) meshes holds data shard r // 2 (pod-major) and
    model slice r % 2, as JAX's row-major device grid."""
    for r, out in enumerate(worlds["ranks"]):
        assert out["_host_mesh"] == [{"data": WORLD}, r, 0]
        assert out["_mesh_index"] == {"(4, 2)": [r // 2, r % 2], "(2, 2, 2)": [r // 2, r % 2]}


def test_gloo_ranks_import_no_jax_or_repro(worlds):
    modules = [r["_modules"] for r in worlds["ranks"]]
    assert all(m == [] for m in modules), modules


def test_fused_raw_partials_sum_to_the_unsplit_theta():
    """The fused schedule's identity on the plain version: a class-grouped
    granule table split into 4 contiguous parts; the raw partials summed,
    then scaled once, equal the unsplit Θ — Θ_PR bit for bit, the others
    within rtol=1e-6 — and JAX's ``_theta_fused_xla_raw`` gives the same."""
    import jax.numpy as jnp
    import torch

    from repro.core.plan import _theta_fused_xla_raw
    from repro_torch.kernels.contingency import fused_theta_raw, fused_theta_ref, theta_scale

    rng = np.random.default_rng(3)
    G, nc, V, m, K = 4096, 7, 5, 3, 300
    r = np.sort(rng.integers(0, K, G)).astype(np.int32)   # classes contiguous
    x_t = rng.integers(0, V, (nc, G)).astype(np.int32)
    d = rng.integers(0, m, G).astype(np.int32)
    w = rng.integers(1, 50, G).astype(np.float32)
    w[rng.random(G) < 0.2] = 0.0
    packed = torch.from_numpy(r[None, :] * V + x_t)
    dt, wt = torch.from_numpy(d), torch.from_numpy(w)
    n = torch.tensor(float(w.sum()))
    cuts = [0, 1000, 2100, 3000, G]
    cuts = [int(np.searchsorted(r, r[c], "left")) if 0 < c < G else c for c in cuts]
    for delta in DELTAS:
        whole = fused_theta_ref(packed, dt, wt, n, delta=delta, n_bins=K * V, n_dec=m)
        parts = sum(fused_theta_raw(packed[:, lo:hi].contiguous(), dt[lo:hi], wt[lo:hi],
                                    delta=delta, n_bins=K * V, n_dec=m)
                    for lo, hi in zip(cuts, cuts[1:]))
        split = theta_scale(delta, parts, n)
        ref = _theta_fused_xla_raw(delta, jnp.asarray(packed.numpy()), jnp.asarray(d),
                                   jnp.asarray(w), jnp.asarray(w != 0), n_bins=K * V, m=m)
        if delta == "PR":
            assert torch.equal(split, whole)
            np.testing.assert_array_equal(
                fused_theta_raw(packed, dt, wt, delta=delta, n_bins=K * V, n_dec=m).numpy(),
                np.asarray(ref))
        else:
            torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(
                fused_theta_raw(packed, dt, wt, delta=delta, n_bins=K * V, n_dec=m).numpy(),
                np.asarray(ref), rtol=1e-6)


def test_cli_distributed_matches_single_process(capsys):
    """``--distributed --mesh 2,2`` on 4 gloo ranks prints the reduct of the
    run without ``--distributed``; ``--collective fused`` too."""
    from repro_torch.launch import reduce as cli

    flags = ["--dataset", "mushroom", "--max-rows", "600", "--max-attrs", "10",
             "--delta", "SCE", "--device", "cpu"]
    serial = cli.main(flags)
    for coll in ("all_reduce", "fused"):
        out = cli.main(flags + ["--distributed", "--mesh", "2,2", "--collective", coll])
        assert (out["reduct"], out["core"]) == (serial["reduct"], serial["core"])
        assert out["mesh"] == {"data": 2, "model": 2}
        np.testing.assert_allclose(out["theta_history"], serial["theta_history"],
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(SystemExit):
        cli.main(flags + ["--distributed", "--backend", "sweep"])
    assert "--backend not supported with --distributed" in capsys.readouterr().err


def test_cli_runs_as_one_rank_under_torchrun():
    """With ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` in the environment (as
    ``torchrun`` sets them) the CLI is one rank of that world, rendezvous on
    a localhost port, and prints the single-process reduct."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = ["--dataset", "mushroom", "--max-rows", "300", "--max-attrs", "6",
             "--delta", "PR", "--device", "cpu", "--json"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.reduce"]
    one = subprocess.run(cmd + flags, env=env, capture_output=True, text=True, timeout=120)
    rank_env = {**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    mesh = subprocess.run(cmd + flags + ["--distributed", "--mesh", "1,1"], env=rank_env,
                          capture_output=True, text=True, timeout=120)
    assert one.returncode == 0 and mesh.returncode == 0, one.stderr + mesh.stderr
    got, want = json.loads(mesh.stdout), json.loads(one.stdout)
    assert got["mesh"] == {"data": 1, "model": 1}
    assert (got["reduct"], got["theta_history"]) == (want["reduct"], want["theta_history"])


def test_spawn_defaults_to_the_card(monkeypatch):
    """``spawn`` runs NCCL ranks unless the caller asks for the CPU: without
    a card it raises before starting a rank, never a silent gloo world."""
    import torch

    from repro_torch.distributed import spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        spawn(print, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 GPUs; 1 visible"):
        spawn(print, 2)


def test_cli_refuses_a_mesh_larger_than_the_gpus(capsys, monkeypatch):
    """NCCL puts one rank on one card: ``--device cuda --mesh 4,2`` on a
    one-GPU machine is an error naming the GPU count, before any rank."""
    import torch

    from repro_torch.launch import reduce as cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--dataset", "mushroom", "--distributed", "--mesh", "4,2",
                  "--device", "cuda"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "needs 8 ranks, one GPU each" in err and "1 GPU(s) visible" in err

"""The paper's tables on the port against the JAX package's harness.

``repro_torch.launch.paper_tables`` runs each of the five tables at a tiny
size on the CPU (``table_10`` over PR and SCE), and
``benchmarks/paper_tables.py`` (imported from the repo root, unchanged)
runs the same table at the same arguments.  Every
reduction either table calls is recorded: the two sequences of calls have
the same arguments (the port's ``device``/``backend`` aside), equal reducts,
cores and iteration counts, the Θ_PR history bit-equal and the other
measures' within rtol=1e-6, atol=1e-7 (``test_torch_reduction.py``'s
bounds).  The rows carry JAX's keys, and equal ``selected`` counts.  The
JAX side runs its host loop (its device engine records the same bits, by
the JAX package's own tests), which keeps its compiles few.

Also here: ``table_6_9`` on the CUDA kernel backends' plain versions, the
CLI's JSON lines, ``examples/pt_quickstart.py --device cpu``, and the row
hash of a wide table summed over column blocks (sdss's 5,201 columns).
"""
import contextlib
import functools
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.paper_tables as J  # noqa: E402
from repro.core.granularity import build_granularity as j_build  # noqa: E402
from repro.core.granularity import row_fingerprints as j_fingerprints  # noqa: E402
from repro_torch.core import granularity as t_granularity  # noqa: E402
from repro_torch.launch import paper_tables as P  # noqa: E402

torch.set_num_threads(1)

TINY = {
    "table_6_9": dict(deltas=["PR", "SCE"], datasets=["tic-tac-toe"], max_rows=60),
    "table_10": dict(max_rows=40),
    "table_11": dict(max_rows=60, max_attrs=12),
    "table_12": dict(max_rows=40, max_attrs=12),
    "fig_9": dict(max_rows=40),
}
# table_10 loops over its module's DELTAS: here PR (bit-equal) and SCE (a log measure)
TINY_DELTAS = {"table_10": ["PR", "SCE"]}
TIME_KEYS = ("_s", "speedup")      # row values that are times or their ratios
REDUCTIONS = ("plar_reduce", "har_reduce", "fspa_reduce")


@contextlib.contextmanager
def _recording(module, **force):
    """Replace ``module``'s three reductions with recorders: each call's
    name, arguments (``device``/``backend`` dropped) and result."""
    calls = []
    saved = {name: getattr(module, name) for name in REDUCTIONS}

    def recorder(name, fn):
        @functools.wraps(fn)
        def call(x, d, **kw):
            r = fn(x, d, **kw, **force)
            calls.append((name, {k: v for k, v in kw.items() if k not in ("device", "backend")},
                          r))
            return r
        return call

    for name, fn in saved.items():
        setattr(module, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _same_result(name, kw, got, want):
    ctx = (name, kw)
    assert (got.reduct, got.core, got.iterations) == (want.reduct, want.core,
                                                     want.iterations), ctx
    assert len(got.theta_history) == len(want.theta_history), ctx
    if kw["delta"] == "PR":
        assert got.theta_history == [float(v) for v in want.theta_history], ctx
        assert got.theta_full == float(want.theta_full), ctx
    else:
        for a, b in zip(got.theta_history + [got.theta_full],
                        list(want.theta_history) + [want.theta_full]):
            assert math.isclose(a, float(b), rel_tol=1e-6, abs_tol=1e-7), ctx


@contextlib.contextmanager
def _deltas(module, table):
    saved = module.DELTAS
    module.DELTAS = TINY_DELTAS.get(table, saved)
    try:
        yield
    finally:
        module.DELTAS = saved


@functools.lru_cache(maxsize=None)
def _jax_run(table):
    with _recording(J, engine="host") as calls, _deltas(J, table):
        rows = J.ALL_TABLES[table](**TINY[table])
    return rows, calls


@pytest.mark.parametrize("table", list(TINY))
def test_table_matches_the_jax_harness(table):
    want_rows, want_calls = _jax_run(table)
    with _recording(P) as calls, _deltas(P, table):
        rows = P.ALL_TABLES[table](device="cpu", **TINY[table])
    assert len(rows) == len(want_rows)
    for row, want in zip(rows, want_rows):
        assert list(row) == list(want), (row, want)
        for k, v in want.items():
            if not any(t in k for t in TIME_KEYS):
                assert row[k] == v, (k, row, want)
            else:
                assert isinstance(row[k], float) and math.isfinite(row[k]), (k, row)
    assert [(n, kw) for n, kw, _ in calls] == [(n, kw) for n, kw, _ in want_calls]
    for (name, kw, got), (_, _, want) in zip(calls, want_calls):
        _same_result(name, kw, got, want)


@pytest.mark.parametrize("backend", ["sweep", "fused", "pallas"])
def test_table_6_9_on_kernel_backends_selects_the_same(backend):
    """The kernel backends' plain versions on the CPU: the same reducts and
    Θ_PR bits as ``segment`` (the card phase runs ``table_6_9`` on sweep)."""
    kw = dict(deltas=["PR", "SCE"], datasets=["tic-tac-toe"], max_rows=60, device="cpu")
    with _recording(P) as plain:
        rows = P.table_6_9(**kw)
    with _recording(P) as kern:
        got = P.table_6_9(backend=backend, **kw)
    assert [r["selected"] for r in got] == [r["selected"] for r in rows]
    for (name, a, r1), (_, _, r0) in zip(kern, plain):
        _same_result(name, a, r1, r0)


def test_cli_prints_json_lines(tmp_path, capsys, monkeypatch):
    out = tmp_path / "rows.jsonl"
    monkeypatch.setitem(P.ALL_TABLES, "table_11",
                        functools.partial(P.table_11, **TINY["table_11"]))
    rows = P.main(["--table", "table_11", "--device", "cpu", "--out", str(out)])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed[0] == {"card": "cpu", "device": "cpu", "backend": "segment"}
    assert printed[1:] == rows
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    assert [(r["table"], r["lanes"]) for r in rows] == [("table_11", 32), ("table_11", 128)]
    if not torch.cuda.is_available():   # the default is the card: never a silent CPU run
        with pytest.raises(RuntimeError, match="cuda"):
            P.table_11(max_rows=20, max_attrs=4)


def test_pt_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    """``examples/pt_quickstart.py --device cpu``, its mushroom table cut to
    600 rows in the test (the script reduces all 5,644)."""
    spec = importlib.util.spec_from_file_location(
        "pt_quickstart", os.path.join(ROOT, "examples", "pt_quickstart.py"))
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    table = quickstart.scaled_paper_dataset
    monkeypatch.setattr(quickstart, "scaled_paper_dataset",
                        lambda name, max_rows: table(name, max_rows=600))
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "decision table: 600 samples" in out
    for delta in ("PR", "SCE", "LCE", "CCE"):
        assert f"Δ = {delta}" in out
    assert out.count("HAR agrees") == 4


@pytest.mark.parametrize("block", [1, 64, 1000])
def test_wide_table_hash_is_summed_over_column_blocks(monkeypatch, block):
    """The row hash summed over column blocks (bounded temporaries at sdss
    width) gives JAX's fingerprints and JAX's granularity."""
    rng = np.random.default_rng(block)
    x = rng.integers(0, 8, (40, 300)).astype(np.int32)
    x[20:] = x[:20]                       # duplicate rows: granules of weight 2
    d = rng.integers(0, 17, 40).astype(np.int32)
    d[20:] = d[:20]
    monkeypatch.setattr(t_granularity, "_HASH_BLOCK_CELLS", block)
    for seed in (0, 7919):
        got = t_granularity.row_fingerprints(torch.from_numpy(x), seed).numpy()
        assert np.array_equal(got, np.asarray(j_fingerprints(x, seed)).astype(np.int64))
    g = t_granularity.build_granularity(torch.from_numpy(x), torch.from_numpy(d), n_dec=17,
                                        v_max=8)
    jg = j_build(x, d, n_dec=17, v_max=8)
    assert int(g.num) == int(jg.num) == 20
    for f in ("x", "d", "w", "valid"):
        assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f))), f

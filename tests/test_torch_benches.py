"""The port's bench modules and serving example on the CPU, at smoke sizes.

Each bench section asserts the JAX benchmark's correctness guarantees
itself (``repro_torch.launch.bench_*``); these tests run the sections on
``device="cpu"`` at small sizes and check what they report:

* serve: batched results byte-identical to single-flight (parity), 6
  identical queries make 1 engine run (dedup), and queries over the queue
  depth are refused with ``ServerOverloaded`` and served again afterwards;
* chaos: a lost shard re-folded to the unfailed fingerprint, a warm
  restart that repairs (``warm == 1``) to the same answer, and a fault
  storm fully answered (at least 3 faults fired, at least 2 retries);
* obs: the tracer records spans of the firehose; the traced chaos run's
  Perfetto JSON holds engine, scheduler, checkpoint and recovery spans and a
  flight-recorder dump lies beside the checkpoints;
* ingest: the monolithic and streaming builds give equal granule counts;
* ``examples/pt_serve_lm.py``: its tokens equal the port's
  ``ServingEngine`` called directly on the same seeded weights.

No wall-clock ratio is asserted here (a shared CPU makes them flaky); the
command line's bound check is tested on a stub section.
"""
import json
import os
import runpy

import pytest

from repro_torch.launch import bench_chaos, bench_common, bench_ingest, bench_obs, bench_serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_parity_dedup_and_admission():
    rows = bench_serve.serve_batched_vs_single_flight(device="cpu", n_rows=1200, rounds=1)
    batched, single, speedup = rows
    assert batched["mode"] == "batched" and single["mode"] == "single_flight"
    assert batched["queries"] == single["queries"] == len(bench_serve.CLIENTS)
    assert batched["engine_runs"] < single["engine_runs"]        # windows coalesced
    assert speedup["parity"] == "ok" and speedup["speedup"] > 0
    dedup, admission = bench_serve.serve_dedup_and_admission(device="cpu", n_rows=600)
    assert dedup["engine_runs"] == 1 and dedup["dedup_hits"] == 5
    assert admission["rejected"] >= 1 and admission["recovered"] is True


def test_chaos_refold_restart_and_storm():
    refold, = bench_chaos.chaos_refold_vs_rebuild(device="cpu", n_rows=2400, chunk_rows=256)
    assert refold["parity"] == "bitwise" and refold["shards"] == bench_chaos.N_SHARDS
    restart, = bench_chaos.chaos_restart_warm_vs_cold(device="cpu", n_rows=1500)
    assert restart["restored"] == 1 and restart["parity"] == "reduct"
    storm, = bench_chaos.chaos_fault_storm_absorbed(device="cpu", n_rows=2000)
    assert storm["answered"] == 4 and storm["faults_fired"] >= 3 and storm["retries"] >= 2


def test_obs_overhead_probe_and_traced_chaos():
    off, on, bound = bench_obs.obs_tracer_overhead(device="cpu", n_rows=1200, rounds=1,
                                                   loops=2000)
    assert off["probe"] == "span_disabled" and on["spans_per_query"] > 0
    assert bound["overhead_frac"] == pytest.approx(
        bound["spans_per_query"] * off["ns_per_span"] * 1e-9 / bound["per_query_s"])
    trace, = bench_obs.obs_trace_chaos(device="cpu", n_rows=1200, chunk_rows=512)
    assert trace["ok"] and trace["dumps"] >= 1 and trace["recovered_shards"] == 1
    assert {"engine", "scheduler", "checkpoint", "recovery"} <= set(trace["by_cat"])


def test_ingest_paths_agree():
    rows = bench_ingest.ingest_stream_vs_monolithic(device="cpu",
                                                    shapes=[("shuttle", 3000, 512)])
    mono, stream, ratio = rows
    assert mono["granules"] == stream["granules"] > 0
    assert mono["device_peak_mb"] is None and ratio["rss_ratio"] > 0


def test_cli_exits_nonzero_on_a_missed_bound(capsys):
    sections = {"probe": lambda device: [{"ratio": 1.2}]}
    met = [bench_common.Bound("probe", "ratio", ">=", 1.0)]
    out = bench_common.main("stub", sections, met, ["--device", "cpu"])
    assert out == {"probe": [{"ratio": 1.2}]}
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("card: ")
    assert json.loads(lines[-1])["bound_met"] is True
    missed = [bench_common.Bound("probe", "ratio", ">=", 1.5)]
    with pytest.raises(SystemExit) as e:
        bench_common.main("stub", sections, missed, ["--device", "cpu"])
    assert e.value.code == 1
    assert "probe.ratio=1.2 (>= 1.5)" in capsys.readouterr().err


def test_serve_example_equals_the_engine(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    ex = runpy.run_path(os.path.join(ROOT, "examples", "pt_serve_lm.py"),
                        run_name="pt_serve_lm")
    done = ex["main"](["--arch", "tinyllama-1.1b", "--requests", "3", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "none")])
    cfg = get_config("tinyllama-1.1b").reduced()
    engine = ServingEngine(cfg, build_model(cfg, device="cpu"), max_batch=4,
                           cache_len=ex["CACHE_LEN"], device="cpu")
    direct = engine.serve(ex["requests"](cfg, 3))
    assert [r.output for r in done] == [r.output for r in direct]
    assert all(len(r.output) > 0 for r in done)

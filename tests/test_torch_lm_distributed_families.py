"""Every LM family of the port sharded on a (2, 2) gloo mesh against itself
unsharded.

One world of 4 gloo ranks (``repro_torch.distributed.spawn``) builds each
reduced config twice from one seed, places one copy's parameters by its
``param_shardings`` (``model.shard(mesh)``) and runs both on the same
inputs: the loss and every gradient leaf (training), then a prefill and two
greedy decode steps (serving), the sharded calls under ``use_mesh``.  The
unsharded port equals JAX (``test_torch_families.py``), so this holds the
sharding layer alone: the constrain points, the islands (flash and RWKV6
kernels on local heads, MoE, the vocab-parallel embedding and loss, the
sequence-sharded decode), and the DTensor propagation between them.
Bounds: the loss within 1e-5 relative, each gradient leaf within
1e-4·max|g|, the logits within 1e-4·max|logits| (f32: the sharded sums run
in another order).  2 x 12 tokens: the MoE capacity is counted on the
tokens an island routes (a data shard's under expert parallelism, as in
JAX), so the sizes stay in the drop-free regime (t ≤ 32) both ways.
tinyllama runs again with activation recompute on (the recompute reruns
the islands under the mesh).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.join(ROOT, "tests")
DEADLINE_S = 240
CASES = ["tinyllama-1.1b", "tinyllama-1.1b+remat", "gemma-2b", "minitron-4b",
         "mistral-nemo-12b", "rwkv6-3b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b",
         "jamba-1.5-large-398b", "llava-next-34b", "seamless-m4t-medium"]


def _rank(dev, out_dir: str) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import make_mesh, unshard, use_mesh
    from repro_torch.models import build_model

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    results = {}
    for case in CASES:
        arch, _, option = case.partition("+")
        cfg = get_config(arch).reduced()
        if option == "remat":
            cfg = dataclasses.replace(cfg, remat=True, remat_policy="nothing")
        gen = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        if cfg.is_encdec:
            batch["frames"] = torch.randn(2, 10, cfg.frontend_dim, generator=gen)
        elif cfg.frontend:
            batch["frontend_feats"] = torch.randn(2, cfg.frontend_tokens, cfg.frontend_dim,
                                                  generator=gen)
        ref = build_model(cfg, device="cpu")
        model = build_model(cfg, device="cpu").shard(mesh)
        got = {}
        for tag, m, mm in (("one", ref, None), ("mesh", model, mesh)):
            m.requires_grad_(True)
            with use_mesh(mm):
                loss, _ = m.loss(batch)
                names, params = zip(*m.named_parameters())
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    if cfg.is_encdec:
                        cache, n = m.prefill(batch, 16)
                        logits = []
                        tok = toks[:, :1]
                    else:
                        lg, cache, n = m.prefill(batch, 20)
                        logits = [unshard(lg)]
                        tok = logits[0][:, -1:].argmax(-1)
                    for _ in range(2):
                        lg, cache, n = m.decode(cache, tok, n)
                        logits.append(unshard(lg))
                        tok = logits[-1][:, -1:].argmax(-1)
            got[tag] = dict(loss=float(unshard(loss)),
                            grads={k: unshard(g) for k, g in zip(names, grads)},
                            logits=logits)
        one, sh = got["one"], got["mesh"]
        rec = {"loss": [one["loss"], sh["loss"]], "grad_err": {}, "logit_err": []}
        for name, g in one["grads"].items():
            scale = float(g.abs().max())
            rec["grad_err"][name] = [float((sh["grads"][name] - g).abs().max()), scale]
        for a, b in zip(one["logits"], sh["logits"]):
            rec["logit_err"].append([float((b - a).abs().max()), float(a.abs().max())])
        results[case] = rec
    results["modules"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                                or m == "repro" or m.startswith("repro."))
    if mesh.rank == 0:
        with open(os.path.join(out_dir, "families.json"), "w") as f:
            json.dump(results, f)


def _main(out_dir: str) -> None:
    from repro_torch.distributed import spawn
    spawn(_rank, 4, (out_dir,), device="cpu", timeout_s=DEADLINE_S - 20)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("families_world"))
    boot = (f"import sys; sys.path[:0] = [{TESTS!r}, {SRC!r}]; "
            f"import test_torch_lm_distributed_families as H; H._main({tmp!r})")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    p = subprocess.run([sys.executable, "-c", boot], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=DEADLINE_S)
    assert p.returncode == 0, (p.stdout + p.stderr)[-6000:]
    with open(os.path.join(tmp, "families.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES)
def test_family_sharded_equals_unsharded(results, case):
    rec = results[case]
    one, sh = rec["loss"]
    assert abs(sh - one) <= 1e-5 * abs(one), (case, sh, one)
    for name, (err, scale) in rec["grad_err"].items():
        assert scale > 0 or name.endswith("bias"), (case, name)
        assert err <= 1e-4 * scale, (case, name, err, scale)
    assert len(rec["logit_err"]) >= 2
    for err, scale in rec["logit_err"]:
        assert err <= 1e-4 * scale, (case, err, scale)


def test_family_ranks_import_no_jax(results):
    assert results["modules"] == []

"""LM distribution on the card: a world of one NCCL rank, mesh (1, 1).

Marked ``cuda``: every test takes the ``nccl_mesh`` fixture, which skips
with a reason where PyTorch sees no card (decided inside the fixture, never
at import).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py

The sharded step runs the kernels through ``local_map``-style islands on
DTensor shards (``to_local`` → the ctypes kernel under its differentiable
wrapper → ``from_local``), so these tests hold the local gradients: a
reduced tinyllama and rwkv6 Trainer step on the mesh equals the unsharded
step on the card (loss within 1e-5·|loss|, every gradient leaf within
1e-4·max|grad|, f32, TF32 off), and the flash and RWKV6 launch counters
move on the mesh path as often as off it (no plain attention, no plain RWKV
loop).  Serving: the reduced models' greedy tokens under ``use_mesh``
equal the unsharded ones.
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

ARCHS = ["tinyllama-1.1b", "rwkv6-3b"]


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the NCCL mesh needs a card")
    import os

    import torch.distributed as dist

    from repro_torch.distributed import init_process_group, make_mesh

    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_test_"), "store")
    init_process_group("cuda", rank=0, world_size=1, store_path=store, timeout_s=300)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def _launches():
    return {**flash_ops.launch_counts(), **rwkv_ops.launch_counts()}


def _reset():
    flash_ops.reset_launch_counts()
    rwkv_ops.reset_launch_counts()


def _step(cfg, mesh):
    """One Trainer step: (loss, grad norm, gradients by leaf, launches)."""
    from repro_torch.distributed import P, shard_by_shape, unshard, use_mesh

    tr = Trainer(cfg, TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4), mesh=mesh,
                 device="cuda", seed=3)
    state = tr.init_state()
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             TokenStream(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=1).batch(0).items()}
    _reset()
    placed = batch if mesh is None else {
        k: shard_by_shape(P(("pod", "data")), v.shape, mesh).place(v) for k, v in batch.items()}
    tr.model.requires_grad_(True)
    with use_mesh(mesh):
        loss, _ = tr.model.loss(placed)
        names, params = zip(*tr.model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    grads = {n: unshard(g).detach().float().cpu() for n, g in zip(names, grads)}
    state, met = tr.step_fn(state, {k: v.cpu().numpy() for k, v in batch.items()})
    return float(unshard(loss)), float(met["grad_norm"]), grads, _launches()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_unsharded_on_the_card(nccl_mesh, arch):
    cfg = get_config(arch).reduced()
    loss0, gnorm0, grads0, launches0 = _step(cfg, None)
    loss1, gnorm1, grads1, launches1 = _step(cfg, nccl_mesh)
    assert abs(loss1 - loss0) <= 1e-5 * abs(loss0), (loss1, loss0)
    assert abs(gnorm1 - gnorm0) <= 1e-5 * abs(gnorm0), (gnorm1, gnorm0)
    for name, g in grads1.items():
        want = grads0[name]
        assert float(want.abs().max()) > 0, name
        assert float((g - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
    kernel = "flash_attention" if arch == "tinyllama-1.1b" else "rwkv6"
    assert launches1[kernel] > 0 and launches1 == launches0, (launches1, launches0)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_tokens_equal_unsharded(nccl_mesh, arch):
    from repro_torch.distributed import unshard, use_mesh

    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).cuda()

    def greedy(mesh):
        _reset()
        with torch.no_grad(), use_mesh(mesh):    # DTensor views fail under inference_mode
            logits, cache, n = model.prefill(toks, 64)
            out = [unshard(logits)[:, -1].argmax(-1, keepdim=True)]
            for _ in range(6):
                logits, cache, n = model.decode(cache, out[-1], n)
                out.append(unshard(logits)[:, -1].argmax(-1, keepdim=True))
        return torch.cat(out, 1).cpu(), _launches()

    want, launches0 = greedy(None)
    model.shard(nccl_mesh)
    got, launches1 = greedy(nccl_mesh)
    assert torch.equal(got, want), (got, want)
    assert launches1 == launches0 and sum(launches1.values()) > 0, (launches1, launches0)


def test_partition_path_equals_whole_table_on_four_cards(tmp_path):
    """The mesh driver with each rank's own partition handed over, on 4 NCCL
    ranks (mesh (4, 1), one card a rank) at 200,000 kdd99-shaped rows: bit
    for bit the whole-table path under every schedule, on every rank, with
    the ``mesh.*`` spans recorded (``test_torch_mesh_partition.py``'s world,
    on the cards).  Needs 4 visible cards; skips otherwise."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: the partition path on 4 NCCL ranks")
    import test_torch_mesh_partition as H

    ranks = H.run_world(str(tmp_path), device="cuda", rows=200_000)
    for coll, engine in H.CASES:
        H.assert_partition_equals_whole(ranks, f"{coll}/{engine}")
        for rec in ranks:
            assert set(rec["cases"][f"{coll}/{engine}"]["spans"]) == set(H.SPAN_ATTRS)

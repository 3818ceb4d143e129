"""The LM serving path's CUDA kernels on the card, and serving card vs CPU.

Marked ``cuda``: every test takes the ``cuda_device`` fixture, which skips
with a reason where PyTorch sees no card (decided inside the fixture, never
at import).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

Tolerances: flash attention rtol = atol = 2e-5 in f32 and, in bf16, one
output rounding per element (rtol 1e-2, atol 2e-3; the JAX kernel tests'
0.05 would pass a wrong kernel at the long shapes, where |out| is ~0.05).
bf16 at head widths 64, 128 and 256 runs the tensor-core kernel, the rest
the f32 kernel; each test asserts which one a launch took;
RWKV6 rtol = atol = 1e-4, on both of its paths (decode below the chunk
length, chunked from it on), with sigmoid decays and with the model's
decays w = exp(−exp(z)), z over [−8, 4].  Both against the
kernels' plain versions on the same card.  Served tokens card == CPU, in f32
with TF32 off, for the dense, RWKV6, MoE, Mamba-hybrid and VLM families (the
VLM's prefill with frontend features too) and the enc-dec's greedy decode.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                takes_tensor_cores)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6 import CHUNK, rwkv6, rwkv6_ref
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.cuda

FLASH_SHAPES = [  # b, hq, hkv, sq, skv, dh, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 192, 192, 64, True, None),
    (2, 4, 4, 96, 160, 32, True, None),
    (1, 4, 2, 256, 256, 64, True, 48),
    (1, 2, 2, 64, 64, 128, False, None),
    (1, 2, 1, 64, 64, 256, True, None),
    (1, 4, 4, 1, 160, 64, True, None),
    (1, 32, 4, 1024, 1024, 64, True, None),   # tinyllama prefill, full width
    (1, 8, 1, 300, 300, 256, True, None),     # gemma-2b heads
    (1, 32, 8, 2048, 2048, 128, True, None),  # mistral-nemo-12b heads, 2,048 tokens
    (2, 16, 16, 300, 300, 64, False, None),   # seamless-m4t encoder heads, non-causal
    (1, 8, 2, 200, 200, 128, False, None),    # non-causal GQA at Dh 128, a ragged tile
    (1, 4, 1, 96, 160, 64, False, None),      # non-causal, more keys than queries
    (1, 64, 4, 512, 512, 128, True, None),    # qwen3-moe heads: a GQA group of 16
]
RWKV_SHAPES = [  # b, h, t, d
    (2, 2, 64, 16), (1, 3, 128, 32), (2, 1, 33, 8), (1, 2, 256, 64), (1, 1, 7, 4),
    (1, 40, 512, 64),    # one rwkv6-3b request: 40 heads, columns split over 4 CTAs
    (4, 40, 1, 64),      # a decode step of 4 requests: 160 heads
    (4, 40, 40, 64),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, seed, b, hq, hkv, sq, skv, dh, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, dh, causal, window, dtype):
    q, k, v = _qkv(cuda_device, sq + dh, b, hq, hkv, sq, skv, dh, dtype)
    before = flash_ops.launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = flash_ops.launch_counts()
    tc = dtype == torch.bfloat16 and dh in (64, 128, 256)
    assert takes_tensor_cores(dtype, dh) == tc
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_tc"] == before["flash_attention_tc"] + int(tc)
    assert got.dtype == dtype
    want = attention_ref(q, k, v, causal=causal, window=window)
    # bf16: both round the same f32 value once, so each element is within
    # one rounding (|d| <= 1e-2·|want| + 2e-3)
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 2e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_flash_bf16_tile_skip_is_exact_and_masked_rows_are_zero(cuda_device):
    """The tensor-core kernel on the tile-skip shapes: within one output
    rounding of the plain version, rows that see no key exactly 0."""
    for sq, skv in ((200, 456), (100, 64), (130, 130)):
        q, k, v = _qkv(cuda_device, sq + 1, 1, 4, 2, sq, skv, 64, torch.bfloat16)
        for window in (48, None):
            before = flash_ops.launch_counts()["flash_attention_tc"]
            got = flash_attention(q, k, v, causal=True, window=window)
            assert flash_ops.launch_counts()["flash_attention_tc"] == before + 1
            want = attention_ref(q, k, v, causal=True, window=window)
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=2e-3)
    q, k, v = _qkv(cuda_device, 5, 1, 4, 2, 100, 64, 64, torch.bfloat16)
    assert torch.all(flash_attention(q, k, v, causal=True)[:, :, :36] == 0)


def test_flash_tile_skip_is_exact(cuda_device):
    """window 48 with sq < skv: most kv tiles lie wholly before the window,
    and sq > skv rows see none; the skipped tiles change nothing."""
    for sq, skv in ((200, 456), (100, 64)):
        q, k, v = _qkv(cuda_device, sq, 1, 4, 2, sq, skv, 64, torch.float32)
        for window in (48, None):
            got = flash_attention(q, k, v, causal=True, window=window)
            want = attention_ref(q, k, v, causal=True, window=window)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.all(flash_attention(q, k, v, causal=True)[:, :, :36] == 0)


@pytest.mark.parametrize("b,h,t,d", RWKV_SHAPES)
def test_rwkv6_kernel_matches_plain(cuda_device, b, h, t, d):
    g = torch.Generator(device=cuda_device).manual_seed(t * 31 + d)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device)  # noqa: E731
    r, k, v = rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5
    w, u, s0 = torch.sigmoid(rnd(b, h, t, d)), rnd(h, d) * 0.5, rnd(b, h, d, d) * 0.1
    before = rwkv_ops.launch_counts()["rwkv6"]
    o, s = rwkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rwkv_ops.launch_counts()["rwkv6"] == before + 1
    o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


def _rwkv_inputs(dev, seed, b, h, t, d):
    """Model-distribution decays: w = exp(-exp(z)), z over [-8, 4]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    z = torch.rand((b, h, t, d), generator=g, device=dev) * 12 - 8
    return (rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5,
            torch.exp(-torch.exp(z)), rnd(h, d) * 0.5, rnd(b, h, d, d) * 0.1)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("t_of", ["1", "7", "L-1", "L", "L+1", "100", "1000"])
def test_rwkv6_paths_match_plain_with_model_decays(cuda_device, b, t_of):
    t = {"1": 1, "7": 7, "L-1": CHUNK - 1, "L": CHUNK, "L+1": CHUNK + 1, "100": 100,
         "1000": 1000}[t_of]
    r, k, v, w, u, s0 = _rwkv_inputs(cuda_device, t + b, b, 40, t, 64)
    path = "rwkv6_decode" if t < CHUNK else "rwkv6_chunked"
    before = rwkv_ops.launch_counts()
    o, s = rwkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    after = rwkv_ops.launch_counts()
    assert after[path] == before[path] + 1 and after["rwkv6"] == before["rwkv6"] + 1
    o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,h,t,d", [(1, 40, 2048, 64), (2, 3, 100, 32), (1, 2, 77, 16),
                                     (2, 2, 50, 8), (1, 1, 65, 4)])
def test_rwkv6_chunked_kernel_at_each_head_width(cuda_device, b, h, t, d):
    r, k, v, w, u, s0 = _rwkv_inputs(cuda_device, rwkv_ops.CHUNK + t, b, h, t, d)
    before = rwkv_ops.launch_counts()["rwkv6_chunked"]
    o, s = rwkv6(r, k, v, w, u, s0)
    assert rwkv_ops.launch_counts()["rwkv6_chunked"] == before + 1
    o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


def test_rwkv6_decode_steps_chain_into_the_chunked_state(cuda_device):
    """A chunked prefill, then decode steps on its state, equal the plain
    version over the whole sequence."""
    r, k, v, w, u, s0 = _rwkv_inputs(cuda_device, 5, 2, 40, 70, 64)
    o, s = rwkv6(*(x[:, :, :66].contiguous() for x in (r, k, v, w)), u, s0)
    outs = [o]
    for i in range(66, 70):
        o_i, s = rwkv6(*(x[:, :, i:i + 1].contiguous() for x in (r, k, v, w)), u, s)
        outs.append(o_i)
    o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(torch.cat(outs, dim=2), o_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)


def test_rwkv6_unaligned_operands_match_aligned(cuda_device):
    """Contiguous operands that start one float past a 16-byte boundary take
    the kernel's 4-byte staging path and give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, t, d = 2, 5, 77, 64
    ops_ = [torch.randn((b, h, t, d), generator=g, device=cuda_device) * 0.5 for _ in range(3)]
    ops_.append(torch.sigmoid(torch.randn((b, h, t, d), generator=g, device=cuda_device)))
    u = torch.randn((h, d), generator=g, device=cuda_device) * 0.5
    s0 = torch.randn((b, h, d, d), generator=g, device=cuda_device) * 0.1
    shifted = [torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape).copy_(x)
               for x in ops_]
    assert all(x.data_ptr() % 16 for x in shifted) and all(x.is_contiguous() for x in shifted)
    o, s = rwkv6(*ops_, u, s0)
    o_u, s_u = rwkv6(*shifted, u, s0)
    assert torch.equal(o, o_u) and torch.equal(s, s_u)


def test_wrappers_reject_bad_operands(cuda_device):
    q, k, v = _qkv(cuda_device, 0, 1, 4, 2, 16, 16, 64, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="like q"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    qb = q.to(torch.bfloat16)
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    shifted = shifted.view(qb.shape).copy_(qb)   # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, k.to(torch.bfloat16), v.to(torch.bfloat16))
    r = torch.rand((1, 2, 5, 16), device=cuda_device)
    u = torch.rand((2, 16), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rwkv6(r.double(), r.double(), r.double(), r.double(), u.double())
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6(r.transpose(2, 3).contiguous().transpose(2, 3), r, r, r, u)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rwkv6(r, r, r, r, u.cpu())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b", "qwen3-moe-235b-a22b",
                                  "kimi-k2-1t-a32b", "jamba-1.5-large-398b", "llava-next-34b"])
def test_reduced_model_served_on_card_equals_cpu(cuda_device, arch):
    cfg = get_config(arch).reduced()
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (3, 9, 14, 20, 11, 5)]

    def serve(model, device):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, model, max_batch=3, cache_len=48, device=device)
        return [r.output for r in eng.serve(reqs)]

    flash_ops.reset_launch_counts()
    rwkv_ops.reset_launch_counts()
    assert serve(card, cuda_device) == serve(cpu, "cpu")
    counts = {**flash_ops.launch_counts(), **rwkv_ops.launch_counts()}
    assert counts["rwkv6" if arch.startswith("rwkv") else "flash_attention"] > 0
    if arch.startswith("rwkv"):   # prompts of 3-20 tokens: decode-path prefills and steps
        assert counts["rwkv6_decode"] > 0
    if cfg.frontend:              # a prefill with the frontend's features, card against CPU
        feats = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, cfg.frontend_tokens + 6)))
        with torch.inference_mode():
            want, _, _ = cpu.prefill({"tokens": toks, "frontend_feats": feats}, 24)
            got, _, _ = card.prefill({"tokens": toks.to(cuda_device),
                                      "frontend_feats": feats.to(cuda_device)}, 24)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_reduced_encdec_on_card_equals_cpu(cuda_device):
    """seamless-m4t reduced: the encoder's non-causal flash launches (one a
    layer), then 6 greedy decode steps; tokens equal and logits within
    1e-4·max|logit| of the CPU's."""
    cfg = get_config("seamless-m4t-medium").reduced()
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    card = build_model(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    frames = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, 40, cfg.frontend_dim)).astype(np.float32))

    def greedy(model, device):
        with torch.inference_mode():
            cache, lengths = model.prefill({"frames": frames.to(device)}, 8)
            tok = torch.zeros((3, 1), dtype=torch.long, device=device)
            toks, logits = [], []
            for _ in range(6):
                lg, cache, lengths = model.decode(cache, tok, lengths)
                tok = lg[:, -1].argmax(-1, keepdim=True)
                toks.append(tok.cpu())
                logits.append(lg.cpu())
        return torch.cat(toks, 1), torch.cat(logits, 1)

    flash_ops.reset_launch_counts()
    got_toks, got = greedy(card, cuda_device)
    assert flash_ops.launch_counts()["flash_attention"] == cfg.enc_layers
    want_toks, want = greedy(cpu, "cpu")
    assert torch.equal(got_toks, want_toks)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))

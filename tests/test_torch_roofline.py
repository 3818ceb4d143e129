"""The port's roofline machinery (``repro_torch.launch.roofline``), mirroring
``tests/test_roofline.py``: terms, extrapolation and ``model_flops`` against
the JAX package's on the same configs.

Left out: ``test_parse_collectives_counts_and_bytes``.  The port has no HLO
to parse: JAX's ``parse_collectives`` and ``parse_convert_bytes`` feed its
``dryrun.py`` from compiled HLO text, where the port counts collectives
and casts as its step runs (``StepCounter``, tested in
``tests/test_torch_specs.py`` and ``tests/test_torch_dryrun_lm.py``).
"""
import dataclasses

import pytest

from repro.configs import get_config as j_get_config
from repro.launch import roofline as j_rl
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.configs import cells, get_config
from repro_torch.launch import roofline as rl
from repro_torch.models.config import SHAPES


def test_extrapolation_linear():
    assert rl.extrapolate(10.0, 14.0, 5) == 10.0 + 4 * 4.0
    assert rl.extrapolate(10.0, 9.0, 5) == 10.0  # negative delta clamps
    s1 = rl.CollectiveStats({"all-reduce": 1}, {"all-reduce": 8}, {"all-reduce": 12.0})
    s2 = rl.CollectiveStats({"all-reduce": 2}, {"all-reduce": 16}, {"all-reduce": 20.0,
                                                                    "all-gather": 3.0})
    assert rl.extrapolate_collectives(s1, s2, 4) == {"all-reduce": 36.0, "all-gather": 9.0}
    assert s2.total_wire_bytes == 23.0
    j1 = j_rl.CollectiveStats(s1.counts, s1.result_bytes, s1.wire_bytes)
    j2 = j_rl.CollectiveStats(s2.counts, s2.result_bytes, s2.wire_bytes)
    assert rl.extrapolate_collectives(s1, s2, 4) == j_rl.extrapolate_collectives(j1, j2, 4)
    assert s2.as_dict() == j2.as_dict()


def test_roofline_terms_dominance():
    t = rl.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "memory"
    f32 = rl.roofline_terms(67e12 * 3, 3.35e12 * 2, 0.0, dtype="f32")
    assert f32["compute_s"] == pytest.approx(3.0) and f32["dominant"] == "compute"
    with pytest.raises(ValueError, match="unknown operand type"):
        rl.roofline_terms(1.0, 1.0, 0.0, dtype="fp8")
    # JAX's three terms on the TPU's figures are the port's on the card's
    assert j_rl.roofline_terms(197e12, 819e9 * 2, 50e9 * 0.5) == t


def test_h100_figures_have_one_home():
    spec = rl.H100_SXM
    assert (spec.hbm_bytes_per_s, spec.f32_ops_per_s, spec.bf16_ops_per_s,
            spec.nvlink_bytes_per_s) == (3.35e12, 67e12, 989e12, 450e9)
    assert (spec.sms, spec.smem_per_block, spec.regs_per_sm, spec.threads_per_sm) == (
        132, 232_448, 65_536, 2_048)
    assert (rl.HBM_BW, rl.PEAK_FLOPS, rl.PEAK_FLOPS_F32, rl.NVLINK_BW) == (
        3.35e12, 989e12, 67e12, 450e9)
    assert rl.device_spec("cpu") is spec and rl.device_spec() is spec
    assert dataclasses.replace(spec, name="x").peak_ops("bf16") == 989e12


@pytest.mark.parametrize("arch,shape", sorted({(a, s) for a, s in cells()}))
def test_model_flops_equal_jax(arch, shape):
    """The same arithmetic as JAX's over the port's own configs."""
    assert rl.model_flops(get_config(arch), SHAPES[shape]) == pytest.approx(
        j_rl.model_flops(j_get_config(arch), J_SHAPES[shape]), rel=1e-12)


def test_model_flops_train_scales_6nd():
    cfg = get_config("tinyllama-1.1b")
    shape = SHAPES["train_4k"]
    mf = rl.model_flops(cfg, shape)
    nd6 = 6.0 * cfg.param_count() * shape.global_batch * shape.seq_len
    assert nd6 < mf < nd6 * 1.5


def test_model_flops_moe_uses_active_params():
    cfg = get_config("qwen3-moe-235b-a22b")
    shape = SHAPES["train_4k"]
    mf = rl.model_flops(cfg, shape)
    active = 6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    total = 6.0 * cfg.param_count() * shape.global_batch * shape.seq_len
    assert active * 0.9 < mf < total * 0.25


def test_model_flops_decode_is_tiny_vs_train():
    cfg = get_config("mistral-nemo-12b")
    assert (rl.model_flops(cfg, SHAPES["decode_32k"])
            < rl.model_flops(cfg, SHAPES["train_4k"]) / 1000)


def test_window_caps_attention_span():
    cfg = get_config("jamba-1.5-large-398b")
    assert rl.model_flops(cfg, SHAPES["long_500k"]) < 2.5 * cfg.active_param_count()

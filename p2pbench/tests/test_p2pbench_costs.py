"""The frozen yardstick (``p2pbench/costs.py`` and the reference's model
arithmetic) equals the program's own at the cells' shapes, and the
reference's parameters are the program's, name for name and shape for
shape."""
import json
import math
from pathlib import Path

import pytest
import torch

from p2pbench import costs, harness
from p2pbench.reference import lm, vgg
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.configs.base import TRAIN_4K, ModelConfig
from repro_torch.kernels import cost as program_cost
from repro_torch.launch import dryrun, mesh

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]}
VGG, MAMBA = CONFIGS["vgg11-cifar10"], CONFIGS["mamba2-370m"]


def test_peaks():
    assert (costs.PEAK_FLOPS_BF16, costs.PEAK_FLOPS_FP32, costs.HBM_BW) == (
        mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_FP32, mesh.HBM_BW)


def leaf_sizes():
    return [math.prod(shape) for _, shape, _ in vgg.param_spec(VGG)]


@pytest.mark.parametrize("peers", [4])
def test_codec_costs_at_vgg11s_leaves(peers):
    assert len(leaf_sizes()) == 22
    for n in leaf_sizes():
        nb = -(-n // 2048)
        assert costs.qsgd_quantize_cost(peers * nb, 2048) == program_cost.qsgd_quantize_cost(peers * nb, 2048)
        assert costs.qsgd_dequantize_cost(peers * nb, 2048) == program_cost.qsgd_dequantize_cost(peers * nb, 2048)
        assert costs.qsgd_dequant_reduce_cost(peers, nb, 2048) == program_cost.qsgd_dequant_reduce_cost(
            peers, nb, 2048)
        k = max(1, min(n, int(round(n * 0.01))))
        assert costs.topk_select_cost(peers, n, k) == program_cost.topk_select_cost(peers, n, k)
        for own in (False, True):
            assert costs.topk_scatter_cost(peers, k, 1, n, own) == program_cost.topk_scatter_cost(
                peers, k, 1, n, own)


@pytest.mark.parametrize("stats", [False, True])
def test_flash_costs_at_zamba2s_shape(stats):
    q = torch.empty((2, 2048, 32, 64), dtype=torch.bfloat16, device="meta")
    assert costs.flash_attention_cost(tuple(q.shape), tuple(q.shape), 2, stats=stats) == \
        program_cost.flash_attention_cost(q, q, stats=stats)
    assert costs.flash_attention_backward_cost(tuple(q.shape), tuple(q.shape), 2) == \
        program_cost.flash_attention_backward_cost(q, q)
    assert costs.valid_pairs(2048, 2048) == program_cost.valid_pairs(2048, 2048)


def test_mamba2_model_flops():
    cfg = ModelConfig(**MAMBA["model"])
    assert costs.lm_param_count(MAMBA["model"]) == cfg.active_param_count() == 368_271_360
    assert get_config("mamba2-370m").active_param_count() == 368_274_432  # its vocabulary 50,280
    ssd = 3 * 48 * costs.ssd_forward_flops_per_token(MAMBA["model"])
    assert costs.lm_train_flops(MAMBA["model"], TRAIN_4K.global_batch * TRAIN_4K.seq_len) == \
        dryrun.model_flops(cfg, TRAIN_4K) + ssd * TRAIN_4K.global_batch * TRAIN_4K.seq_len
    assert abs(costs.lm_train_flops(MAMBA["model"], 2 * 16 * 2048) - 165.22e12) < 0.01e12


def test_ssd_flops_are_the_chunked_products():
    """The SSD's products, counted at a small size on the reference's scan
    with the heads' B and C shared (one group): C B^T once per chunk pair
    of the group, the rest per head. The state passing between chunks,
    2 H P N (c + 1)^2 a sequence of c chunks, is not counted: 1 % of the
    rest at 2,048 tokens."""
    m = dict(MAMBA["model"], d_model=64, ssm_headdim=16, ssm_state=8, ssm_chunk=16)
    S, H, P, N = 64, 8, 16, 8
    args = (torch.zeros(1, S, H, P), torch.zeros(1, S, H), torch.zeros(H), torch.zeros(1, S, 1, N),
            torch.zeros(1, S, 1, N))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as count:
        lm.ssd(*args, chunk=16)
    per_token = costs.ssd_forward_flops_per_token(m)
    assert per_token == 2 * 16 * 8 + 2 * 16 * 128 + 4 * 128 * 8
    # the reference forms C B^T per head; the model FLOPs count it per group
    passing = 2 * H * P * N * (S // 16 + 1) ** 2
    assert count.get_total_flops() - 2 * 16 * N * (H - 1) * S - passing == per_token * S


def test_vgg11_forward_flops_are_the_counted_ones():
    cfg = ModelConfig(**VGG["model"])
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros((2, 3, 32, 32))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as count:
        model(x)
    assert count.get_total_flops() == 2 * vgg.forward_flops(VGG)
    assert vgg.forward_flops(VGG) == 343_359_488
    assert sum(math.prod(s) for _, s, _ in vgg.param_spec(VGG)) == 28_144_010


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_parameters_are_the_programs(name):
    config = CONFIGS[name]
    spec = harness.family(config).reference.param_spec(config)
    program = harness.program_parameters(config)
    assert {k: tuple(v.shape) for k, v in program.items()} == {n: s for n, s, _ in spec}


def test_make_params_follows_the_spec():
    spec = lm.param_spec({"model": dict(MAMBA["model"], num_layers=2, d_model=64, vocab_size=500,
                                        ssm_state=16, ssm_headdim=16)})
    a, b = (harness.make_params(spec, 2**31 + 5, "cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["layers.0.mixer.A_log"], torch.log(torch.linspace(1, 16, 8)))
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(a["layers.0.mixer.D"], torch.ones(8))

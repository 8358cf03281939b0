"""The Zamba2 cell on the CPU at a small size (d 64, 2 groups, hybrid layers
[2, 4, 6] of 8, 48 tokens, float32): the timed step sound is ``correct``,
broken underneath it is not, and the control (the reference in fp8) fails a
limit. Then the family's frozen arithmetic at the cell's shapes: the model
FLOPs' parameter count against ``ModelConfig``'s, the attention's and the
SSD's products counted on the reference, and the flash roofline's bound
against the program's cost formulas."""
import copy
import math

import pytest
import torch
import torch.utils.flop_counter

from p2pbench import costs, harness
from p2pbench.families import zamba2
from p2pbench.reference import zamba2 as ref
from p2pbench.tests import small

torch.set_num_threads(2)  # the test workers share the CPU with each other

CELL = "zamba2-7b.p2x2x4096.mean"
TINY = dict(num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96,
            vocab_size=500, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            hybrid_layer_ids=[2, 4, 6], adapter_rank=8, dtype="float32")
MANIFEST, FULL_CELL, FULL_CONFIG = harness.load_cell(CELL)


def tiny():
    data, config = copy.deepcopy(FULL_CELL), copy.deepcopy(FULL_CONFIG)
    config["model"].update(TINY)
    data.update(seq_len=48)
    return data, config


@pytest.fixture(scope="module", autouse=True)
def reference_once():
    with small.reference_once():
        yield


def test_sound_step_is_correct():
    data, config = tiny()
    result = small.run(CELL, data, config, MANIFEST)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange", "altered"])
def test_broken_step_is_not_correct(fault, monkeypatch):
    data, config = tiny()
    with small.planted(fault, monkeypatch):
        result = small.run(CELL, data, config, MANIFEST)
    assert not result["correct"], result["checks"]


def test_control_fails_a_limit():
    data, config = tiny()
    fam = harness.family(config)
    base = harness.reference_readings(fam, config, data, small.SEED, "cpu")
    control = harness.reference_readings(fam, config, data, small.SEED, "cpu",
                                         precision=config["control"])
    numbers = harness.compare(control, base)
    assert any(numbers[k] > limit for k, limit in data["limits"].items()), numbers


def test_applied_parameters_count_each_application():
    from repro_torch.configs.base import ModelConfig

    m = FULL_CONFIG["model"]
    cfg = ModelConfig(**m)
    apps, blocks = len(m["hybrid_layer_ids"]), m["num_mem_blocks"]
    assert cfg.param_count() == 2_733_050_240
    assert zamba2.applied_param_count(m) == cfg.param_count() + (apps - blocks) * \
        cfg.shared_block_param_count() == 3_401_014_656
    assert abs(zamba2.train_flops(FULL_CONFIG, FULL_CELL) - 352.45e12) < 0.01e12


def test_attention_and_ssd_flops_are_the_counted_products():
    """One application's attention at a small size on the reference's
    ``_heads``: its two products over all S^2 pairs, of which the causal
    half (S (S + 1) / 2 pairs) are counted; the SSD's at G = 2 as
    ``test_p2pbench_costs`` counts them (C B^T per group)."""
    m = dict(FULL_CONFIG["model"], num_heads=4, head_dim=32)
    n, S = 1, 64
    q = torch.zeros(n, S, 4, 32)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as count:
        ref._heads(q, q, q, 1.0)
    full = count.get_total_flops()
    assert full == 4 * 4 * 32 * S * S
    assert zamba2.attention_flops_per_token(m, S) * S == full * (S + 1) / 2 / S
    mm = dict(m, d_model=64, ssm_headdim=16, ssm_state=8, ssm_chunk=16, ssm_ngroups=2)
    H, P, N, G = 8, 16, 8, 2
    args = (torch.zeros(1, S, H, P), torch.zeros(1, S, H), torch.zeros(H), torch.zeros(1, S, G, N),
            torch.zeros(1, S, G, N))
    with torch.utils.flop_counter.FlopCounterMode(display=False) as count:
        ref.ssd(*args, chunk=16)
    passing = 2 * H * P * N * (S // 16 + 1) ** 2
    per_head_cb = 2 * 16 * N * (H - G) * S  # the reference forms C B^T per head
    assert count.get_total_flops() - per_head_cb - passing == \
        costs.ssd_forward_flops_per_token(mm) * S


def test_flash_bound_is_the_programs_cost_per_launch():
    from repro_torch.kernels import cost as program_cost

    q = torch.empty((4, 4096, 32, 224), dtype=torch.bfloat16, device="meta")
    fwd = program_cost.flash_attention_cost(q, q, stats=True)
    bwd = program_cost.flash_attention_backward_cost(q, q)
    assert costs.flash_attention_cost(tuple(q.shape), tuple(q.shape), 2, stats=True) == fwd
    peak = costs.PEAK_FLOPS_BF16
    want = 8 * costs.bound_s(*fwd, peak) + 4 * costs.bound_s(*bwd, peak)
    got = zamba2.flash_bound_s(FULL_CONFIG, FULL_CELL, {"flash_attention": 8.0,
                                                         "flash_attention_backward": 4.0})
    assert math.isclose(got, want, rel_tol=1e-12) and abs(got - 17.507e-3) < 1e-5
    assert zamba2.flash_bound_s(FULL_CONFIG, FULL_CELL, {}) == 0.0
    assert zamba2.FLASH_KERNELS.search("void flash_attention_kernel_wgmma<224>(CUtensorMap_st)")
    assert zamba2.FLASH_KERNELS.search("void bwd_dkdv_wgmma<224>(float const*)")
    assert not zamba2.FLASH_KERNELS.search("void flash_attention_kernel<float>(float const*)")

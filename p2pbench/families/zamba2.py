"""Zamba2 LMs as released (the program's ``hybrid`` family with
``hybrid_layer_ids``): batches, units and the program's loss as
``families/lm.py`` has them; the reference is ``reference/zamba2.py``;
the model FLOPs are frozen here (``train_flops``). The model computes in
bfloat16, so its peak is the tensor cores' bfloat16 rate."""
from __future__ import annotations

import re

from p2pbench import costs
from p2pbench.families.lm import make_batch, program_loss, units  # noqa: F401 (the family's API)
from p2pbench.reference import zamba2 as reference

UNIT = "tokens"
PEAK_FLOPS = costs.PEAK_FLOPS_BF16
# the flash kernels' bf16 symbols: the forward and the backward's two launches
FLASH_KERNELS = re.compile(r"flash_attention_kernel_wgmma|bwd_dq_wgmma|bwd_dkdv_wgmma")


def applied_param_count(m: dict) -> int:
    """The parameters a token's forward multiplies by, as ``ModelConfig``
    counts them for the release layout, with the shared blocks, their
    LoRA and the layer's linear counted once per application: the tied
    embedding (the head), the final norm, each layer's norm and Mamba-2
    mixer (in_proj, the biased conv, A_log, D, dt_bias, the gated norm,
    out_proj), and per application the block (2 d and d of norms,
    attention from 2 d, the gated MLP), the LoRA (d -> rank -> 2 d_ff) and
    the (d, d) linear."""
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    di = m["ssm_expand"] * d
    H, N, G, K = di // m["ssm_headdim"], m["ssm_state"], m["ssm_ngroups"], m["ssm_conv"]
    A = m["num_heads"] * m["head_dim"]
    mamba = d * (2 * di + 2 * G * N + H) + (K + 1) * (di + 2 * G * N) + 3 * H + di + di * d
    block = 3 * d + 2 * d * (A + 2 * m["num_kv_heads"] * m["head_dim"]) + A * d + 3 * d * f
    app = block + r * (d + 2 * f) + d * d
    return m["vocab_size"] * d + d + m["num_layers"] * (d + mamba) + len(m["hybrid_layer_ids"]) * app


def attention_flops_per_token(m: dict, seq_len: int) -> float:
    """One causal application's score and value products for a token of a
    row of ``seq_len``, forward: 4 heads head_dim a key pair, (S + 1) / 2
    keys on average."""
    return 4.0 * m["num_heads"] * m["head_dim"] * (seq_len + 1) / 2


def train_flops(config: dict, cell: dict) -> float:
    """6 N D (N: ``applied_param_count``), plus 3x the attention's products
    in every application and 3x the SSD's chunked products in every layer
    (``costs.ssd_forward_flops_per_token``); remat's recomputation not
    counted."""
    m = config["model"]
    per_token = (6.0 * applied_param_count(m)
                 + 3.0 * len(m["hybrid_layer_ids"]) * attention_flops_per_token(m, cell["seq_len"])
                 + 3.0 * m["num_layers"] * costs.ssd_forward_flops_per_token(m))
    return per_token * units(cell)


def flash_bound_s(config: dict, cell: dict, launches) -> float:
    """The least device time of a step's flash calls: the frozen
    ``costs.flash_attention_cost`` (with the saved statistics, as every
    training forward writes them) and ``flash_attention_backward_cost`` at
    the peers' folded (peers x rows, seq_len, heads, head_dim) bf16 shape,
    causal, each at the bf16 peak or the memory bandwidth, times the calls
    a traced step launched (``launches``, by wrapper)."""
    m = config["model"]
    q = (cell["peers"] * cell["rows_per_peer"], cell["seq_len"], m["num_heads"], m["head_dim"])
    k = (q[0], q[1], m["num_kv_heads"], m["head_dim"])
    fwd = costs.bound_s(*costs.flash_attention_cost(q, k, 2, stats=True), PEAK_FLOPS)
    bwd = costs.bound_s(*costs.flash_attention_backward_cost(q, k, 2), PEAK_FLOPS)
    return (launches.get("flash_attention", 0.0) * fwd
            + launches.get("flash_attention_backward", 0.0) * bwd)


def reference_loss(config: dict):
    return lambda params, batch, precision: reference.loss(params, batch, config, precision)

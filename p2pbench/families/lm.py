"""Mamba-2 LMs (the program's ``ssm`` family): each row a seeded sequence
of ``seq_len + 1`` token ids drawn uniformly over the vocabulary, the
labels the next tokens; the
program's loss is its train step's own (``train.steps.lm_loss``, through
``P2PTrainer`` without a ``loss_fn``); work is counted in tokens. The
model computes in its configured dtype (bfloat16), so its peak is the
tensor cores' bfloat16 rate."""
from __future__ import annotations

import torch

from p2pbench import costs
from p2pbench.reference import lm as reference

UNIT = "tokens"
PEAK_FLOPS = costs.PEAK_FLOPS_BF16


def make_batch(config: dict, cell: dict, generator: torch.Generator, device) -> dict:
    rows = cell["peers"] * cell["rows_per_peer"]
    ids = torch.randint(0, config["model"]["vocab_size"], (rows, cell["seq_len"] + 1),
                        generator=generator, device=device)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def units(cell: dict) -> int:
    return cell["peers"] * cell["rows_per_peer"] * cell["seq_len"]


def train_flops(config: dict, cell: dict) -> float:
    return costs.lm_train_flops(config["model"], units(cell))


def program_loss(config: dict):
    """None: ``P2PTrainer`` builds the LM step over ``lm_loss`` itself."""
    return None


def reference_loss(config: dict):
    return lambda params, batch, precision: reference.loss(params, batch, config, precision)

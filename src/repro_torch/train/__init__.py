"""LM training and serving steps of the port (the reference's
``repro/train``); the trainer facade and checkpoints are ROADMAP.md,
Queue 1, items 9 and 15."""
from repro_torch.train.steps import build_serve_step, build_train_step, init_train_state, lm_loss

__all__ = ["build_serve_step", "build_train_step", "init_train_state", "lm_loss"]

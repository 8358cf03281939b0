"""LM training and serving steps of the port (the reference's
``repro/train``): the step builders, the :class:`P2PTrainer` facade and
npz checkpoints (``train.checkpoint``)."""
from repro_torch.train.steps import build_serve_step, build_train_step, init_train_state, lm_loss
from repro_torch.train.trainer import P2PTrainer

__all__ = ["build_serve_step", "build_train_step", "init_train_state", "lm_loss", "P2PTrainer"]

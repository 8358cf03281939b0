"""The plain reference that decides ``correct``: plain PyTorch in float32
(TF32 off), importing nothing of the program. ``p2p.run_steps`` follows the
first steps of Algorithm 1 (per-peer losses and gradients, the exchange's
combine, error feedback, the optimizer) over the model losses of
``vgg.py`` and ``lm.py``."""

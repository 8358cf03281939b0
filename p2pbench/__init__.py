"""The benchmark of the PyTorch and CUDA port (``repro_torch``): peer-to-peer
training steps through ``P2PTrainer.step`` on one H100. ``run.py`` is the
one command; ``README.md`` says how cells, configurations and metrics are
added as files."""

"""PyTorch/CUDA port of the serverless P2P training system.

A second package beside the JAX reference ``repro``: same module layout and
names, PyTorch inside, hand-written CUDA kernels for Hopper in place of the
Pallas TPU kernels. It imports nothing of ``repro`` and nothing of JAX.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.
"""

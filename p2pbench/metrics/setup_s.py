"""Seconds from the process's start to the first timed step: imports,
weights and batches, the trainer, the kernels' build or load, and the
first steps."""


def read(ctx):
    return ctx.window["setup_s"]

"""The port's twins of ``examples/quickstart.py``,
``examples/cost_explorer.py`` and ``examples/serve_decode.py``, on the CPU.

* ``cost_explorer``: every line equals the reference script's, except the
  wire-cost lines of protocols the port has not ported (none now) and the
  reference's TPU chip-second section, which the twin leaves out. The reference runs
  with its own allocation policies only: ``tests/test_events.py`` registers
  test policies in the reference's registry, which the script lists when
  the two files share a worker.
* ``quickstart``: one epoch on the CPU prints the history, the stage
  breakdown with the executor's simulated stages, one serverless report
  per epoch and the comparison with the instance baseline.
"""
import contextlib
import io
import re
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import events as jevents
from repro.train.checkpoint import _flatten
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.core import available_exchanges
from repro_torch.examples import cost_explorer, quickstart, serve_decode

torch.set_num_threads(2)  # the test workers share the CPU with each other

ROOT = Path(__file__).resolve().parents[1]


def _lines(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def test_cost_explorer_prints_the_reference_lines(monkeypatch):
    monkeypatch.setattr(jevents, "_ALLOC_REGISTRY", {
        name: cls for name, cls in jevents._ALLOC_REGISTRY.items()
        if cls.__module__ == jevents.__name__})
    theirs = _lines(lambda: runpy.run_path(str(ROOT / "examples" / "cost_explorer.py"),
                                           run_name="__main__"))
    ours = _lines(cost_explorer.main)
    theirs = theirs[:theirs.index("=== TPU equivalent: cost/step of the serverless-P2P train step ===")]
    while theirs and not theirs[-1]:
        theirs.pop()
    start = theirs.index("=== Exchange wire cost: VGG11-sized gradient, 4 peers, 1 Gb/s ===")
    stop = theirs.index("", start)
    protocols = theirs[start + 1:stop]
    kept = [line for line in protocols if line.split()[0] in available_exchanges()]
    assert [line.split()[0] for line in kept] == list(available_exchanges())
    assert ours == theirs[:start + 1] + kept + theirs[stop:]


def test_quickstart_runs_one_epoch_on_the_cpu():
    lines = _lines(lambda: quickstart.main(["--device", "cpu", "--epochs", "1"]))
    text = "\n".join(lines)
    assert lines[0].startswith("overlay: ring(P=4")
    assert lines[1].startswith("exchange=allgather_mean: ")
    assert sum(line.startswith("epoch 0: loss=") for line in lines) == 1
    for stage in ("compute_gradients", "send_gradients", "receive_gradients", "model_update",
                  "convergence_detection", "cold_start", "queue_wait", "retry"):
        assert any(line.startswith(stage) for line in lines), stage
    assert "epoch 0 serverless execution (simulated accounting" in text
    assert "2 lambdas x " in text
    assert "serverless vs instance (t2.large): " in text
    assert "nan" not in text


SERVE_GEN = 10  # the example's 48 tokens cut to 10 (its printed sample's length)


def _reference_decode(jcfg, params, batch, gen):
    """The reference example's loop (its untimed first step, then ``gen``
    greedy steps), keeping each step's logits."""
    step = jax.jit(lambda p, s, t: jmodels.decode_step(p, s, t, jcfg))
    state = jmodels.init_decode_state(jcfg, batch, gen + 8)
    first, state = step(params, state, jnp.ones((batch, 1), jnp.int32))
    tok, logits = jnp.argmax(first, -1)[:, None].astype(jnp.int32), []
    for _ in range(gen):
        out, state = step(params, state, tok)
        logits.append(np.asarray(out, np.float32))
        tok = jnp.argmax(out, -1)[:, None].astype(jnp.int32)
    return np.asarray(first, np.float32), np.stack(logits, 1)


@pytest.mark.parametrize("arch", serve_decode.ARCHS)
def test_serve_decode_twin_holds_to_the_reference_example(arch):
    example = runpy.run_path(str(ROOT / "examples" / "serve_decode.py"), run_name="example")
    theirs = _lines(lambda: example["serve"](arch, gen=SERVE_GEN))
    jcfg = jreduced(jget_config(arch), vocab_size=512)
    cfg = reduced(get_config(arch), vocab_size=512)
    params = jmodels.init_model(jax.random.PRNGKey(0), jcfg)  # the example's weights
    model = models.init_model(cfg, generator=torch.Generator(), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(params), cfg, device="cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first, toks = serve_decode.serve(arch, gen=SERVE_GEN, device="cpu", model=model)
    ours = out.getvalue().splitlines()
    rate = re.compile(r" *\d+\.\d tok/s")
    assert len(ours) == len(theirs) == 1 and rate.sub("", ours[0]).split("sample")[0] == \
        rate.sub("", theirs[0]).split("sample")[0]
    jfirst, jlogits = _reference_decode(jcfg, params, 4, SERVE_GEN)
    jfirst32, _ = _reference_decode(jreduced(jget_config(arch), vocab_size=512, dtype="float32"),
                                    params, 4, 1)
    budget = 2 * np.abs(jfirst - jfirst32).max()  # twice the reference's own bf16 error
    assert 0 < budget < 0.05 * np.abs(jfirst32).max()
    np.testing.assert_allclose(first, jfirst, atol=budget, rtol=0)
    jtoks = jlogits.argmax(-1)
    sample = [int(t) for t in theirs[0].split("sample: [")[1].rstrip("]").split(",")]
    assert jtoks[0].tolist() == sample  # the loop above is the example's
    top2 = np.sort(jlogits, -1)
    margin = top2[..., -1] - top2[..., -2]
    for r in range(4):  # up to the first token that parts, which must be a close call
        for i in range(SERVE_GEN):
            if toks[r, i] != jtoks[r, i]:
                assert margin[r, i] <= 2 * budget, (r, i, margin[r, i])
                break

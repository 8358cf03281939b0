"""The port's twins of ``examples/quickstart.py`` and
``examples/cost_explorer.py``, on the CPU.

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
import runpy
from pathlib import Path

import torch

from repro.core import events as jevents
from repro_torch.core import available_exchanges
from repro_torch.examples import cost_explorer, quickstart

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

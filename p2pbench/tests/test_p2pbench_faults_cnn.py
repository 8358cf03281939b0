"""A run of the `vgg11.p4x512.mean` cell's harness on the CPU at a small
size (VGG-11 at its full widths, 2 images a peer), with the timed step
sound and then broken underneath: ``correct`` is true, then false for each
fault. The other VGG-11 cells' exchanges (QSGD and top-k with error
feedback) are broken the same way in ``test_p2pbench_faults_lm.py``, on a
small LM: the CPU's plain codecs over VGG-11's 28 M parameters take
seconds a step."""
import pytest
import torch

from p2pbench.tests import small

torch.set_num_threads(2)  # the test workers share the CPU with each other

CELL = "vgg11.p4x512.mean"


@pytest.fixture(scope="module", autouse=True)
def reference_once():
    with small.reference_once():
        yield


MANIFEST, CELL_DATA, CONFIG = small.cell(CELL)


def test_sound_step_is_correct():
    result = small.run(CELL, CELL_DATA, CONFIG, MANIFEST)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange", "altered"])
def test_broken_step_is_not_correct(fault, monkeypatch):
    with small.planted(fault, monkeypatch):
        result = small.run(CELL, CELL_DATA, CONFIG, MANIFEST)
    assert not result["correct"], result["checks"]

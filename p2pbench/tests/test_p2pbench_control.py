"""The control of each configuration (the reference in its place, computed
in the precision next below the configuration's: TF32 for VGG-11's float32,
fp8 for mamba2-370m's bfloat16) fails a limit of its cell, at a size a CPU test
run holds. On the card it is read at the cells' own sizes by
``calibrate.py``."""
import pytest
import torch

from p2pbench import harness
from p2pbench.tests import small

torch.set_num_threads(2)  # the test workers share the CPU with each other


@pytest.mark.parametrize("name", ["vgg11.p4x512.mean", "mamba2-370m.p2x16x2048.mean"])
def test_control_fails_a_limit(name):
    _, data, config = small.cell(name)
    fam = harness.family(config)
    ref = harness.reference_readings(fam, config, data, small.SEED, "cpu")
    control = harness.reference_readings(fam, config, data, small.SEED, "cpu",
                                         precision=config["control"])
    again = harness.reference_readings(fam, config, data, small.SEED, "cpu")
    numbers = harness.compare(control, ref)
    assert any(numbers[k] > limit for k, limit in data["limits"].items()), numbers
    assert harness.compare(again, ref) == dict.fromkeys(numbers, 0.0)  # the reference repeats itself

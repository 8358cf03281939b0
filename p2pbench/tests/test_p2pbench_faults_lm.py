"""A run of the LM cell's harness on the CPU at a small size, with the
timed step sound and then broken underneath: ``correct`` is true, then
false for each fault. The exchanges of the CNN cells (QSGD and top-k with
error feedback) run here on the small LM too, where the CPU's plain codecs
take a fraction of a second a step."""
import pytest
import torch

from p2pbench.tests import small

torch.set_num_threads(2)  # the test workers share the CPU with each other


@pytest.fixture(scope="module", autouse=True)
def reference_once():
    with small.reference_once():
        yield


CELL = "mamba2-370m.p2x16x2048.mean"
EXCHANGES = {
    "mean": {"name": "allgather_mean"},
    "qsgd-ef": {"name": "qsgd", "levels": 127, "bucket": 2048, "ef": True},
    "topk-ef": {"name": "topk", "frac": 0.01, "ef": True},
}


@pytest.mark.parametrize("exchange", sorted(EXCHANGES))
def test_sound_step_is_correct(exchange):
    manifest, data, config = small.cell(CELL, exchange=EXCHANGES[exchange])
    result = small.run(CELL, data, config, manifest)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange", "altered"])
@pytest.mark.parametrize("exchange", sorted(EXCHANGES))
def test_broken_step_is_not_correct(exchange, fault, monkeypatch):
    manifest, data, config = small.cell(CELL, exchange=EXCHANGES[exchange])
    with small.planted(fault, monkeypatch):
        result = small.run(CELL, data, config, manifest)
    assert not result["correct"], result["checks"]

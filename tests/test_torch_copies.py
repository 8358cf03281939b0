"""The port's own copies of the reference's numpy-only modules behave as the
reference's do on the same inputs: configs and ``reduced``, the data pipeline, overlay
graphs, the mailbox, convergence detection, the link model and the stage
metrics. Exact equality throughout (no floating-point work differs)."""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core import convergence as jconv
from repro.core import graph as jgraph
from repro.core import mailbox as jmailbox
from repro.core.events import LinkModel as JLinkModel
from repro.data import pipeline as jpipe
from repro.metrics import StageMetrics as JStageMetrics
from repro_torch.configs import LM_ARCHS, PAPER_ARCHS, get_config, reduced
from repro_torch.core import convergence, graph, mailbox
from repro_torch.core.events import LinkModel
from repro_torch.data import pipeline
from repro_torch.metrics import StageMetrics


@pytest.mark.parametrize("arch", PAPER_ARCHS + LM_ARCHS)
def test_configs_equal_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-370m", {}),
    ("mamba2-370m", dict(num_layers=3)),
    ("mamba2-370m", dict(vocab_size=512)),
    ("gemma2-2b", dict(num_layers=3)),  # local_global_pattern 2, sliding_window 64
    ("qwen2.5-3b", dict(num_layers=3, serve_window=32)),
    ("vgg11", {}),
])
def test_reduced_equals_reference(arch, kw):
    ours, theirs = reduced(get_config(arch), **kw), jreduced(jget_config(arch), **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.d_inner, ours.ssm_heads, ours.padded_vocab, ours.param_count()) == (
        theirs.d_inner, theirs.ssm_heads, theirs.padded_vocab, theirs.param_count())
    assert [(s.mixer, s.ffn) for s in ours.block_specs()] == [
        (s.mixer, s.ffn) for s in theirs.block_specs()]


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(size=256, image_hw=8, channels=1)),
    ("cifar", dict(size=256)),
    ("cifar", dict(size=256, preprocessing="minmax", seed=3)),
    ("lm", dict(size=256, seq_len=16)),
])
def test_batches_are_bit_identical(name, kw):
    ds, jds = pipeline.make_dataset(name, **kw), jpipe.make_dataset(name, **kw)
    part, jpart = pipeline.Partitioner(ds, 4, shuffle_seed=5), jpipe.Partitioner(jds, 4, shuffle_seed=5)
    for peer in range(4):
        np.testing.assert_array_equal(part.partition(peer), jpart.partition(peer))
        loader, jloader = pipeline.DataLoader(part, peer, 8), jpipe.DataLoader(jpart, peer, 8)
        assert loader.num_batches == jloader.num_batches
        for epoch, index in ((0, 0), (2, 3)):
            ours = loader.load(pipeline.BatchKey(peer, epoch, index))
            theirs = jloader.load(jpipe.BatchKey(peer, epoch, index))
            assert sorted(ours) == sorted(theirs)
            for k in ours:
                assert ours[k].dtype == theirs[k].dtype
                np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("spec", ["full", "ring", "gossip:3", "hierarchical:3", "hierarchical"])
def test_graphs_equal_reference(spec):
    g, jg = graph.get_graph(spec, 10, seed=2), jgraph.get_graph(spec, 10, seed=2)
    assert g.describe() == jg.describe()
    np.testing.assert_array_equal(g.adjacency, jg.adjacency)
    np.testing.assert_array_equal(g.mixing_matrix(), jg.mixing_matrix())
    for r in range(10):
        assert g.neighbors(r) == jg.neighbors(r)
        np.testing.assert_array_equal(g.mixing_row(r), jg.mixing_row(r))
    assert g.spectral_gap() == jg.spectral_gap()
    # the reference's own graphs: tests/test_graph.py registers a test graph
    # in the reference's registry, which shows here when the two files share
    # a worker
    theirs = tuple(n for n in jgraph.available_graphs()
                   if jgraph._REGISTRY[n].__module__ == jgraph.__name__)
    assert graph.available_graphs() == theirs


def test_mailbox_equal_reference():
    boxes = [
        mailbox.HostMailbox(4, graph=graph.get_graph("ring", 4)),
        jmailbox.HostMailbox(4, graph=jgraph.get_graph("ring", 4)),
    ]
    seen = []
    for box in boxes:
        log = []
        for epoch in range(2):
            for r in range(4):
                box.publish(r, ("p", r, epoch), nbytes=200 * 1024 * 1024 * (r == 3) + 10,
                            time=0.5 * r, epoch=epoch)
                box.publish(r, ("p", r, epoch), nbytes=10, time=0.5 * r, epoch=epoch)
                box.barrier_signal(r, epoch)
            log.append(box.barrier_complete(epoch))
            box.barrier_reset(epoch)
            for r in range(4):
                for other in range(4):
                    msg = box.consume(other, consumer=r, at_time=1.0)
                    log.append(None if msg is None else (msg.payload, msg.nbytes, msg.via_s3,
                                                         box.download_time_s(msg, 1e9)))
        seen.append((log, box.stats, box.delivered_edges, box.live_messages))
    assert seen[0] == seen[1]


def test_convergence_detector_equal_reference():
    metrics = [0.1, 0.2, 0.2, 0.19, 0.25, float("nan"), 0.24, 0.24, 0.24, 0.24, 0.24, 0.24, 0.3]
    d = convergence.ConvergenceDetector(0.05, mode="max", max_epochs=50)
    jd = jconv.ConvergenceDetector(0.05, mode="max", max_epochs=50)
    for m in metrics:
        assert d.step(m) == jd.step(m)
        assert d.lr == jd.lr
    with pytest.raises(ValueError):
        convergence.EarlyStopping(mode="sideways")


def test_link_model_and_stage_table_equal_reference():
    for bw, over, n in ((1e9, 0.0, 12345), (5e7, 0.002, 1)):
        assert LinkModel(bw, over).transfer_s(n) == JLinkModel(bw, over).transfer_s(n)
    m, jm = StageMetrics(), JStageMetrics()
    for stage, secs in (("send_gradients", 0.25), ("cold_start", 1.5)):
        m.add_simulated(stage, secs)
        jm.add_simulated(stage, secs)
    assert m.table() == jm.table()
    assert StageMetrics.STAGES == JStageMetrics.STAGES

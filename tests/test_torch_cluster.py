"""A 4-peer synchronous Algorithm-1 epoch of the port against the reference,
on the CPU: squeezenet1.1 on MNIST-shaped 8x8 data from the same init (the
reference's, converted), with the ``allgather_mean`` exchange on the full
and the ring graph. ``test_torch_cluster_qsgd.py`` runs the QSGD exchange,
``test_torch_cluster_async.py`` async epochs, the executor and the tracer.

Also here: the reference's refusals (a full-graph protocol on a sparse
overlay; a sharded protocol with ``sync=False``, an adversary or EF; a bad
``trimmed_mean``, ``krum`` or ``tree`` parameter), the same ``ValueError``
on both sides.

Tolerances: params within 1e-5 absolute (convolution gradients are summed
in another order by XLA and oneDNN); wire bytes and mailbox statistics
identical.
"""
import numpy as np
import torch
import pytest

from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import LocalP2PCluster as JCluster
from repro.core.compression import QSGDConfig as JQSGDConfig
from repro.data import make_dataset as jmake_dataset
from repro.train.checkpoint import _flatten
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import LocalP2PCluster, QSGDConfig
from repro_torch.data import make_dataset
from repro_torch.optim import sgd

torch.set_num_threads(2)  # the test workers share the CPU with each other

LR = 0.05
COMMON = dict(num_peers=4, batch_size=8, batches_per_epoch=1, lr=LR, sync=True, seed=0)


def _pair(exchange, graph, qsgd=None, *, ef=False, **kw):
    ref = JCluster(
        jget_config("squeezenet1.1"), jmake_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=joptim.sgd(momentum=0.9), exchange=exchange, graph=graph, ef=ef,
        qsgd=None if qsgd is None else JQSGDConfig(*qsgd), **COMMON, **kw,
    )
    init = convert.from_jax(_flatten(ref.peers[0].params), device="cpu")
    port = LocalP2PCluster(
        get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=sgd(momentum=0.9), exchange=exchange, graph=graph, ef=ef,
        qsgd=None if qsgd is None else QSGDConfig(*qsgd), init_params=init,
        device="cpu", **COMMON, **kw,
    )
    return ref, port


def _gaps(ref, port):
    out = []
    for jp, tp in zip(ref.peers, port.peers):
        theirs, ours = _flatten(jp.params), convert.to_jax(tp.params)
        assert list(theirs) == list(ours)
        out.extend(np.abs(ours[k] - theirs[k]).reshape(-1) for k in theirs)
    return np.concatenate(out)


def _same_accounting(ref, port):
    assert port.mailbox.stats == ref.mailbox.stats
    assert [p.comm_bytes_sent for p in port.peers] == [p.comm_bytes_sent for p in ref.peers]
    assert [p.steps_done for p in port.peers] == [p.steps_done for p in ref.peers]


@pytest.mark.parametrize("graph", ["full", "ring"])
def test_allgather_mean_epoch_matches_reference(graph):
    ref, port = _pair("allgather_mean", graph)
    r_stats, p_stats = ref.run_epoch_sync(0), port.run_epoch_sync(0)
    np.testing.assert_allclose(p_stats["loss"], r_stats["loss"], rtol=1e-5)
    assert _gaps(ref, port).max() <= 1e-5
    _same_accounting(ref, port)


@pytest.mark.parametrize("kwargs,match", [
    (dict(exchange="krum", graph="ring"), "sharded global reduce-scatter .* graph='full'"),
    (dict(exchange="reduce_scatter", graph="ring"), "graph='full'"),
    (dict(exchange="tree", graph="gossip:2"), "graph='full'"),
    (dict(exchange="reduce_scatter", sync=False), "only runs in sync mode"),
    (dict(exchange="tree:3", sync=False), "only runs in sync mode"),
    (dict(exchange="reduce_scatter", adversary="spec"), "whole-gradient"),
    (dict(exchange="tree", ef=True), "error feedback"),
    (dict(exchange="trimmed_mean:0.5"), r"trim fraction must be in \[0, 0.5\)"),
    (dict(exchange="trimmed_mean:-0.1"), r"trim fraction must be in \[0, 0.5\)"),
    (dict(exchange="krum:0"), "selection count must be >= 1"),
    (dict(exchange="tree:1"), "fanout must be >= 2"),
])
def test_the_references_refusals_are_kept(kwargs, match):
    """What the reference's cluster refuses, the port refuses with the same
    ``ValueError``, and so does the reference."""
    from repro.core.robust import AdversarySpec as JAdversarySpec
    from repro_torch.core import AdversarySpec

    for make, spec, mk_cfg, mk_ds, opt in (
        (LocalP2PCluster, AdversarySpec, get_config, make_dataset, sgd),
        (JCluster, JAdversarySpec, jget_config, jmake_dataset, joptim.sgd),
    ):
        args = dict(COMMON, **kwargs)
        if "adversary" in args:
            args["adversary"] = spec(num=1)
        extra = dict(device="cpu") if make is LocalP2PCluster else {}
        with pytest.raises(ValueError, match=match):
            make(mk_cfg("squeezenet1.1"), mk_ds("mnist", size=128, image_hw=8, channels=1),
                 optimizer=opt(momentum=0.9), **args, **extra)

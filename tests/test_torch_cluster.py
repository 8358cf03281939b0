"""A 4-peer synchronous Algorithm-1 epoch of the port against the reference,
on the CPU: squeezenet1.1 on MNIST-shaped 8x8 data from the same init (the
reference's, converted), with the ``allgather_mean`` exchange on the full
and the ring graph. ``test_torch_cluster_qsgd.py`` runs the QSGD exchange.

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


@pytest.mark.parametrize("kwargs,item", [
    (dict(sync=False), "Serverless and instance accounting"),
    (dict(executor=object()), "Serverless and instance accounting"),
    (dict(tracer=object()), "Serverless and instance accounting"),
    (dict(adversary=object()), "Robust, sharded and tree exchange"),
    (dict(reject_nonfinite=True), "Robust, sharded and tree exchange"),
    (dict(exchange="median"), "Robust, sharded and tree exchange"),
    (dict(exchange="trimmed_mean"), "Robust, sharded and tree exchange"),
    (dict(exchange="reduce_scatter"), "Robust, sharded and tree exchange"),
    (dict(exchange="async"), "Serverless and instance accounting"),
])
def test_unported_options_raise_naming_their_roadmap_item(kwargs, item):
    args = dict(COMMON, **kwargs)
    with pytest.raises(NotImplementedError, match=item):
        LocalP2PCluster(
            get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
            optimizer=sgd(momentum=0.9), device="cpu", **args,
        )

"""A 4-peer synchronous Algorithm-1 epoch of the port against the reference
with the top-k exchange, ``topk_frac=0.05``, on the CPU: squeezenet1.1 on
MNIST-shaped 8x8 data from the same init, on the full graph and on the ring
with error feedback. ``psum_mean`` on a sparse overlay is refused, as by
the reference.

Tolerances: params within 1e-5 absolute (XLA and oneDNN sum convolution
gradients in another order); wire bytes and mailbox statistics identical.
The reference runs its ``lax.top_k`` select: on distinct magnitudes it
picks the set the port's (the Pallas kernel's) bisection picks, so the
decoded gradients are the same.
"""
import pytest
import torch

from test_torch_cluster import _gaps, _pair, _same_accounting

torch.set_num_threads(2)  # the test workers share the CPU with each other

P = 4


@pytest.mark.parametrize("graph,ef", [("full", False), ("ring", True)])
def test_topk_epoch_matches_reference(graph, ef):
    ref, port = _pair("topk", graph, ef=ef, topk_frac=0.05)
    ref.run_epoch_sync(0)
    port.run_epoch_sync(0)
    _same_accounting(ref, port)
    assert _gaps(ref, port).max() <= 1e-5


def test_cluster_refuses_psum_mean_on_a_sparse_overlay():
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    with pytest.raises(ValueError, match="graph='full'"):
        LocalP2PCluster(
            get_config("squeezenet1.1"), make_dataset("mnist", size=64, image_hw=8, channels=1),
            num_peers=P, batch_size=4, batches_per_epoch=1, optimizer=sgd(),
            exchange="psum_mean", graph="ring", device="cpu",
        )

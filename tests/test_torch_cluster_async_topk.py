"""Async epochs of the port's ``LocalP2PCluster`` with the top-k exchange
and error feedback on the ring against the reference, on the CPU: 4
squeezenet1.1 peers at speeds (1, 1.25, 1.5, 2) with churn 0.2 and
``sim_compute_s`` pinned, from the same init, so both sides process the
same events in the same order; top-k 5 %, two epochs.

Params within 1e-5 (XLA and oneDNN sum convolution gradients in other
orders); the processing order, clocks, drops and downtime, the wire
accounting and the delivered overlay edges identical.
"""
import numpy as np
import torch

from test_torch_cluster import _gaps
from test_torch_cluster_async import SPEEDS, _pair, _same_async_accounting, _sim_compute

torch.set_num_threads(2)  # the test workers share the CPU with each other


def test_async_topk_ef_on_the_ring_matches_reference():
    ref, port = _pair("topk", "ring", ef=True, topk_frac=0.05, sync=False, peer_speeds=SPEEDS,
                      churn_prob=0.2, churn_downtime_s=0.5, sim_compute_s=_sim_compute)
    for epoch in range(2):
        r_stats, p_stats = ref.run_epoch_async(epoch), port.run_epoch_async(epoch)
        np.testing.assert_allclose(p_stats["loss"], r_stats["loss"], rtol=1e-5)
        _same_async_accounting(ref, port)
    assert port.mailbox.delivered_edges == ref.mailbox.delivered_edges
    assert _gaps(ref, port).max() <= 1e-5

"""An async epoch of the port's ``LocalP2PCluster`` with the QSGD exchange
against the reference, on the CPU: 4 squeezenet1.1 peers at speeds (1,
1.25, 1.5, 2) with churn 0.2 and ``sim_compute_s`` pinned, from the same
init and the reference's uniforms replayed, so both sides process the same
events in the same order. qsgd(7, 256), one epoch.

Tolerances as in ``test_torch_cluster_qsgd.py``: params within 1e-5 except
where one quantization boundary flip explains the gap (gap <= lr * max
bucket norm / s + 1e-5, on at most 1e-4 of all coordinates). The
processing order, clocks, drops and downtime, and the wire accounting are
identical. (The reference's first epoch compiles its codec for every leaf
shape, which is most of this file's time.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_cluster import _gaps
from test_torch_cluster_async import LR, SPEEDS, _pair, _same_async_accounting, _sim_compute
from test_torch_cluster_qsgd import _replay_reference_uniforms

torch.set_num_threads(2)  # the test workers share the CPU with each other


def test_async_qsgd_epoch_matches_reference(monkeypatch):
    s = 7
    kw = dict(sync=False, peer_speeds=SPEEDS, churn_prob=0.2, churn_downtime_s=0.5,
              sim_compute_s=_sim_compute)
    ref, port = _pair("qsgd", "full", (s, 256), **kw)
    _replay_reference_uniforms(monkeypatch, len(port.peers[0].params))
    r_stats, p_stats = ref.run_epoch_async(0), port.run_epoch_async(0)
    np.testing.assert_allclose(p_stats["loss"], r_stats["loss"], rtol=1e-5)
    _same_async_accounting(ref, port)
    max_norm = 0.0
    for r in range(4):
        _, payload = ref.mailbox.consume(r).payload
        norms = [float(jnp.max(p["norms"])) for p in jax.tree_util.tree_leaves(
            payload, is_leaf=lambda p: isinstance(p, dict) and "levels" in p)]
        max_norm = max(max_norm, *norms)
    gaps = _gaps(ref, port)
    assert gaps.max() <= LR * max_norm / s + 1e-5
    assert (gaps > 1e-5).sum() <= 1e-4 * gaps.size

"""A 4-peer synchronous Algorithm-1 epoch of the port against the reference
with the QSGD exchange, qsgd(7, 256), on the CPU: squeezenet1.1 on
MNIST-shaped 8x8 data from the same init, and the reference's uniforms
replayed from its key chain.

Tolerances: XLA and oneDNN sum convolution gradients in different orders,
so a gradient element whose rounding fraction lies within ~1e-6 of its
uniform may round the other way. Such a boundary flip moves one peer's
decoded contribution by norm/s, so params agree within 1e-5 except where a
flip explains the gap (gap <= lr * max bucket norm / s + 1e-5), on at most
1e-4 of all coordinates. Wire bytes and mailbox statistics are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import compression as C
from test_torch_cluster import COMMON, LR, _gaps, _pair, _same_accounting

torch.set_num_threads(2)  # the test workers share the CPU with each other


def _replay_reference_uniforms(monkeypatch, num_leaves):
    """Feed the port the reference's uniforms: per publish the cluster key
    splits (simulate.py:376), the publish key splits once per leaf
    (compression.py:131), and each leaf draws its (nb, bucket) uniforms
    (compression.py:56)."""
    def keys():
        key = jax.random.PRNGKey(COMMON["seed"])
        while True:
            key, sub = jax.random.split(key)
            yield from jax.random.split(sub, num_leaves)

    stream = keys()

    def draw(shape, generator):
        u = jax.random.uniform(next(stream), tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(u)).to(generator.device)

    monkeypatch.setattr(C, "draw_uniforms", draw)


@pytest.mark.parametrize("graph,ef", [("full", False), ("ring", True)])
def test_qsgd_epoch_matches_reference(monkeypatch, graph, ef):
    s = 7
    ref, port = _pair("qsgd", graph, (s, 256), ef=ef)
    _replay_reference_uniforms(monkeypatch, len(port.peers[0].params))
    ref.run_epoch_sync(0)
    port.run_epoch_sync(0)
    _same_accounting(ref, port)
    assert port.protocol.wire_bytes_per_edge(port.peers[0].params, port.xctx) == \
        ref.protocol.wire_bytes_per_edge(ref.peers[0].params, ref.xctx)

    max_norm = 0.0
    for r in range(4):
        _, payload = ref.mailbox.consume(r).payload
        norms = [float(jnp.max(p["norms"])) for p in jax.tree_util.tree_leaves(
            payload, is_leaf=lambda p: isinstance(p, dict) and "levels" in p)]
        max_norm = max(max_norm, *norms)
    gaps = _gaps(ref, port)
    assert gaps.max() <= LR * max_norm / s + 1e-5
    assert (gaps > 1e-5).sum() <= 1e-4 * gaps.size

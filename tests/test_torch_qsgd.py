"""The port's QSGD codec against the reference's, on the CPU.

The plain PyTorch quantize/dequantize are held against the reference's jnp
oracle (``qsgd_quantize_ref`` / ``qsgd_dequantize_ref``) and its Pallas
kernels in interpret mode, with the same uniforms ``u``:

* norms within rtol 1e-5 (the sum of squares is reduced in another order);
* levels identical, except within a band ``|u - frac| < s * 1e-5`` around a
  rounding boundary, where a last-digit difference in the norm may round the
  other way: there they differ by at most 1;
* dequantize bit-identical to the oracle on identical levels and norms
  (within rtol 1e-6 of the Pallas kernel, as the reference's own tests);
* dequantize-and-reduce within rtol 1e-6 of the Pallas kernel and of the
  reference's jnp ``dequant_reduce`` (which dequantizes, then reduces: the
  port follows the Pallas kernel's order, so the two differ in rounding).

The CUDA kernels are held against the plain versions by ``test_cuda_*``
(which skip without a card) and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core.exchange import ExchangeContext as JContext
from repro.core.exchange import get_exchange as jget_exchange
from repro.kernels.qsgd import qsgd_dequant_reduce as pallas_dequant_reduce
from repro.kernels.qsgd import qsgd_dequantize as pallas_dequantize
from repro.kernels.qsgd import qsgd_quantize as pallas_quantize
from repro_torch.core import compression as C
from repro_torch.core.exchange import ExchangeContext, get_exchange
from repro_torch.kernels import qsgd as K

torch.set_num_threads(2)  # the test workers share the CPU with each other


def _inputs(nb, bucket, seed, zero_row=True):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(nb, bucket)) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
    if zero_row:
        x[nb // 2] = 0.0  # an all-zero bucket
    u = rng.random((nb, bucket), dtype=np.float32)
    return x, u


def _assert_levels_match(lev, ref_lev, x, ref_norms, u, s):
    r = np.abs(x) / np.maximum(ref_norms, 1e-30)[:, None] * s
    frac = r - np.floor(r)
    band = np.abs(u - frac) < s * 1e-5
    diff = np.abs(lev.astype(np.int32) - ref_lev.astype(np.int32))
    assert np.all(diff[~band] == 0)
    assert np.all(diff <= 1)


@pytest.mark.parametrize("nb", [1, 7, 13])
@pytest.mark.parametrize("bucket", [256, 512, 2048])
@pytest.mark.parametrize("s", [7, 127])
def test_plain_codec_matches_reference_oracle_and_pallas(nb, bucket, s):
    x, u = _inputs(nb, bucket, seed=nb * 10_000 + bucket + s)
    lev, nrm = K.qsgd_quantize(torch.from_numpy(x), torch.from_numpy(u), s)  # CPU -> plain
    lev, nrm = lev.numpy(), nrm.numpy()
    assert lev.dtype == np.int8 and nrm.dtype == np.float32

    for ref_lev, ref_nrm in (
        JC.qsgd_quantize_ref(jnp.asarray(x), jnp.asarray(u), s),
        pallas_quantize(jnp.asarray(x), jnp.asarray(u), s),  # interpret mode
    ):
        ref_lev, ref_nrm = np.asarray(ref_lev), np.asarray(ref_nrm)
        np.testing.assert_allclose(nrm, ref_nrm, rtol=1e-5, atol=0)
        _assert_levels_match(lev, ref_lev, x, ref_nrm, u, s)

    # int8 sign folded into the level; zero bucket -> zero levels
    assert np.all(lev[nb // 2] == 0) and nrm[nb // 2] == 0.0
    assert np.all(np.sign(lev) * np.sign(x) >= 0)

    ref_lev = np.asarray(JC.qsgd_quantize_ref(jnp.asarray(x), jnp.asarray(u), s)[0])
    deq = K.qsgd_dequantize(torch.from_numpy(ref_lev.copy()), torch.from_numpy(nrm), s).numpy()
    np.testing.assert_array_equal(deq, np.asarray(JC.qsgd_dequantize_ref(ref_lev, nrm, s)))
    # the jitted Pallas body may divide by the constant s as a multiply by its
    # reciprocal, one rounding away from the oracle: its own tests use rtol 1e-6
    np.testing.assert_allclose(deq, np.asarray(pallas_dequantize(ref_lev, nrm, s)), rtol=1e-6)


@pytest.mark.parametrize("peers", [1, 4])
@pytest.mark.parametrize("nb,bucket", [(1, 128), (5, 256), (13, 512)])
@pytest.mark.parametrize("s", [3, 127])
def test_dequant_reduce_matches_pallas_and_oracle(peers, nb, bucket, s):
    rng = np.random.default_rng(peers * 1000 + nb + bucket + s)
    lev = rng.integers(-s, s + 1, size=(peers, nb, bucket)).astype(np.int8)
    nrm = rng.uniform(0.1, 2.0, size=(peers, nb)).astype(np.float32)
    nrm[0, nb // 2] = 0.0  # an all-zero bucket
    w = rng.random(peers).astype(np.float32)
    got = C.dequant_reduce(torch.from_numpy(lev), torch.from_numpy(nrm), torch.from_numpy(w),
                           C.QSGDConfig(s, bucket))
    assert got.shape == (nb, bucket) and got.dtype == torch.float32
    j = (jnp.asarray(lev), jnp.asarray(nrm), jnp.asarray(w))
    for want in (pallas_dequant_reduce(*j, s), JC.dequant_reduce(*j, JC.QSGDConfig(s, bucket))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _leaf_tree(seed):
    """A small dict of leaves in the port's layout (conv OIHW, linear
    (out, in), bias) with ragged sizes that pad into partial buckets."""
    g = torch.Generator().manual_seed(seed)
    return {
        "conv.b": torch.randn(24, generator=g),
        "conv.w": torch.randn(24, 3, 5, 5, generator=g),
        "fc.w": torch.randn(10, 70, generator=g),
    }


def test_payload_is_the_reference_wire_format(monkeypatch):
    """Same leaves and the same uniforms give the reference's payload: leaves
    in JAX flatten order and layout, shape meta, norms, levels (band rule)
    and byte count; decoding the reference's payload gives the reference's
    dense leaves, bit for bit, in the port's layout."""
    from repro_torch import convert

    cfg, jcfg = C.QSGDConfig(levels=7, bucket=256), JC.QSGDConfig(levels=7, bucket=256)
    tree = _leaf_tree(0)
    jl = lambda name: jnp.asarray(convert.to_jax_layout(tree[name]).numpy())
    jtree = {"conv": {"b": jl("conv.b"), "w": jl("conv.w")}, "fc": {"w": jl("fc.w")}}
    key = jax.random.PRNGKey(3)
    jpayload, _ = JC.quantize_tree(jtree, key, jcfg)
    is_payload = lambda p: isinstance(p, dict) and "levels" in p
    jleaves = jax.tree_util.tree_leaves(jpayload, is_leaf=is_payload)

    # replay the reference's uniforms: one split key per leaf, in flatten order
    keys = iter(jax.random.split(key, len(jleaves)))
    drawn = []

    def draw(shape, generator):
        drawn.append(np.array(jax.random.uniform(next(keys), tuple(shape), jnp.float32)))
        return torch.from_numpy(drawn[-1])

    monkeypatch.setattr(C, "draw_uniforms", draw)
    payload = C.quantize_tree(tree, torch.Generator(), cfg)

    assert list(payload) == ["conv.b", "conv.w", "fc.w"]
    for p, jp, x, u in zip(payload.values(), jleaves, jax.tree_util.tree_leaves(jtree), drawn):
        np.testing.assert_array_equal(p["shape"], jp["shape"])
        assert int(p["pad"]) == int(jp["pad"])
        buckets = np.pad(np.asarray(x).reshape(-1), (0, int(jp["pad"]))).reshape(-1, 256)
        np.testing.assert_allclose(p["norms"].numpy(), np.asarray(jp["norms"]), rtol=1e-5)
        _assert_levels_match(p["levels"].numpy(), np.asarray(jp["levels"]), buckets,
                             np.asarray(jp["norms"]), u, 7)
    assert C.payload_bytes(payload) == JC.payload_bytes(jpayload)

    as_port = {
        name: {k: (torch.from_numpy(np.array(v)) if k in ("levels", "norms") else v)
               for k, v in jp.items()}
        for name, jp in zip(payload, jleaves)
    }
    dense = C.dequantize_tree(as_port, cfg)
    jdense = jax.tree_util.tree_leaves(JC.dequantize_tree(jpayload, jcfg))
    for name, jd in zip(payload, jdense):
        assert dense[name].shape == tree[name].shape
        ref = convert.to_torch_layout(torch.from_numpy(np.array(jd)))
        np.testing.assert_array_equal(dense[name].numpy(), ref.numpy())


@pytest.mark.parametrize("bucket", [256, 2048])
def test_wire_bytes_per_edge_matches_reference(bucket):
    from repro.core.graph import get_graph as jget_graph
    from repro_torch.core.graph import get_graph

    tree = _leaf_tree(1)
    jtree = {k: jnp.zeros(tuple(v.shape)) for k, v in tree.items()}
    for graph in ("full", "ring"):
        ctx = ExchangeContext(num_peers=4, qsgd=C.QSGDConfig(127, bucket), graph=get_graph(graph, 4))
        jctx = JContext(num_peers=4, qsgd=JC.QSGDConfig(127, bucket), graph=jget_graph(graph, 4))
        for name in ("qsgd", "allgather_mean"):
            p, jp = get_exchange(name), jget_exchange(name)
            assert p.wire_bytes_per_edge(tree, ctx) == jp.wire_bytes_per_edge(jtree, jctx)
            assert p.wire_bytes(tree, ctx) == jp.wire_bytes(jtree, jctx)
            assert p.host_wire_bytes(tree, ctx) == jp.host_wire_bytes(jtree, jctx)


def test_codec_is_unbiased_with_the_ports_generator():
    """E[Q(v)] = v: the mean of many decodes with the port's own uniforms
    approaches v (the reference's property test, statistically)."""
    cfg = C.QSGDConfig(levels=3, bucket=256)
    x = torch.randn(300, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    n = 2000
    acc = torch.zeros_like(x)
    for _ in range(n):
        acc += C.dequantize(C.quantize(x, g, cfg), cfg)
    norm_bound = float(torch.linalg.vector_norm(x[:256])) / cfg.levels
    assert float((acc / n - x).abs().max()) < 5 * norm_bound / np.sqrt(n)


def test_wrappers_validate_inputs():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="must match"):
        K.qsgd_quantize(x, torch.zeros(4, 128), 7)
    with pytest.raises(ValueError, match="float32"):
        K.qsgd_quantize(x.double(), x.double(), 7)
    with pytest.raises(ValueError, match="levels"):
        K.qsgd_quantize(x, x, 128)
    with pytest.raises(ValueError, match="contiguous"):
        K.qsgd_dequantize(torch.zeros(256, 4, dtype=torch.int8).t(), torch.zeros(4), 7)
    lev = torch.zeros(2, 4, 256, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"must be \(2, 4\) and \(2,\)"):
        K.qsgd_dequant_reduce(lev, torch.zeros(2, 3), torch.ones(2), 7)
    with pytest.raises(ValueError, match="3-d"):
        K.qsgd_dequant_reduce(lev[0], torch.zeros(2, 4), torch.ones(2), 7)
    counters = (K.qsgd_quantize, K.qsgd_dequantize, K.qsgd_dequant_reduce)
    before = [f.launches for f in counters]
    K.qsgd_dequantize(*K.qsgd_quantize(x, x, 7), 7)
    K.qsgd_dequant_reduce(lev, torch.zeros(2, 4), torch.ones(2), 7)
    assert [f.launches for f in counters] == before  # CPU: no launch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.parametrize("nb,bucket", [(8192, 2048), (13, 256), (5, 300)])
def test_cuda_kernels_match_plain(cuda, nb, bucket):
    x, u = _inputs(nb, bucket, seed=nb + bucket)
    xt, ut = torch.from_numpy(x).cuda(), torch.from_numpy(u).cuda()
    lev, nrm = K.qsgd_quantize(xt, ut, 127)
    plev, pnrm = K.quantize_plain(xt, ut, 127)
    torch.cuda.synchronize()
    np.testing.assert_allclose(nrm.cpu().numpy(), pnrm.cpu().numpy(), rtol=1e-5, atol=0)
    _assert_levels_match(lev.cpu().numpy(), plev.cpu().numpy(), x, pnrm.cpu().numpy(), u, 127)
    assert torch.equal(K.qsgd_dequantize(plev, pnrm, 127), K.dequantize_plain(plev, pnrm, 127))


@pytest.mark.parametrize("peers,nb,bucket", [(4, 8192, 2048), (3, 13, 256), (4, 5, 301)])
def test_cuda_dequant_reduce_matches_plain(cuda, peers, nb, bucket):
    rng = np.random.default_rng(nb)
    lev = torch.from_numpy(rng.integers(-127, 128, size=(peers, nb, bucket)).astype(np.int8)).cuda()
    nrm = torch.from_numpy(rng.random((peers, nb), dtype=np.float32)).cuda()
    w = torch.from_numpy(rng.random(peers, dtype=np.float32)).cuda()
    assert torch.equal(K.qsgd_dequant_reduce(lev, nrm, w, 127), K.dequant_reduce_plain(lev, nrm, w, 127))

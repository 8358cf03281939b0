"""The port's robust aggregation and adversary model against the reference,
on the CPU.

* The masked trimmed mean and median on numpy banks with +inf, -inf, NaN
  and ties, full and sparse masks, P = 3..8: equal to the reference's
  value for value (NaN at the same places; the sign of a zero may differ
  only in a median of -0.0 and +0.0, which these banks do not hold).
* Krum: scores within rtol 1e-5 of the reference's (its distances come
  from a Gram matrix, summed in another order), the same selection for
  m = 1..3 and f = None, 0, and the same aggregate, on banks whose scores
  are apart; the reference's refusals.
* Norm clipping within rtol 1e-6 (the norms are sums in another order);
  ``flatten_bank`` the reference's row bit for bit.
* ``AdversarySpec`` attackers equal to the reference's for several seeds,
  fractions and peer counts; ``poison_gradients`` bit for bit, the
  reference's normals injected for ``scaled_noise``, and the port's own
  noise standard normal (statistically).
* The robust combines on the stacked bank against the reference's under
  ``jax.vmap(axis_name="data")``: bit for bit without a clip (full graph
  and the ring's closed neighbourhoods, f32 and a bf16 wire), within rtol
  1e-6 with ``robust_clip``; ``host_combine`` over the arrived ranks.
* One sync epoch of 4 squeezenet1.1 peers (MNIST-shaped 8x8) against the
  reference's: ``trimmed_mean:0.25`` with a ``sign_flip`` attacker,
  ``median`` on the ring with a ``scaled_noise`` attacker (the reference's
  normals injected) and ``reject_nonfinite``, ``krum`` with a ``sign_flip``
  attacker, two epochs of ``stale_replay``: params within 1e-5 (XLA and
  oneDNN sum convolution gradients in other orders), mailbox statistics
  and bytes equal, losses within rtol 1e-5. The attacker's own update and,
  under EF, its residual take its poisoned gradient, as the reference's
  code does.
* Two device steps with ``trimmed_mean:0.25`` and a ``sign_flip``
  attacker (scale 10) against the reference's step (run once, in a
  subprocess with 4 host devices): losses within rtol 1e-5, params and
  momentum within 1e-5 except where the trim keeps the attacker's row,
  which is 10 x the gradient and so carries 10 x the gradients' gap:
  within 1e-4 there, and beyond 1e-5 on at most 1e-4 of the coordinates.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import robust as JR
from repro.core.exchange import ExchangeContext as JContext
from repro.core.exchange import get_exchange as jget_exchange
from repro.core.graph import get_graph as jget_graph
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.core import LocalP2PCluster as JCluster
from repro.data import make_dataset as jmake_dataset
from repro.train.checkpoint import _flatten
from repro_torch import convert, models
from repro_torch.configs import get_config
from repro_torch.core import LocalP2PCluster
from repro_torch.core import exchange as X
from repro_torch.core import p2p
from repro_torch.core import robust as R
from repro_torch.core.graph import get_graph
from repro_torch.core.simulate import cnn_loss
from repro_torch.data import make_dataset
from repro_torch.optim import sgd
from test_torch_cluster import COMMON, _gaps, _same_accounting
from test_torch_shard import _bits, _jax_tree, _tree

torch.set_num_threads(2)  # the test workers share the CPU with each other

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _bank(P, seed, n=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(P, n)).astype(np.float32)
    x[rng.integers(P), :6] = np.inf
    x[rng.integers(P), 6:9] = -np.inf
    x[rng.integers(P), 9:12] = np.nan
    x[:, 12:18] = 1.5  # a tie across every row
    x[: max(P // 2, 2), 18:22] = -2.0  # a tie across some rows
    return x


def _masks(P, seed):
    rng = np.random.default_rng(seed)
    sparse = rng.random(P) < 0.6
    sparse[rng.integers(P)] = True
    return {"full": np.ones(P, bool), "sparse": sparse,
            "ring": get_graph("ring", P).adjacency[0] | (np.arange(P) == 0)}


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32), equal_nan=True)


@pytest.mark.parametrize("mask", ["full", "sparse", "ring"])
@pytest.mark.parametrize("P", [3, 4, 5, 8])
def test_masked_order_statistics_match_the_reference(P, mask):
    for seed in range(4):
        x = _bank(P, seed)
        m = _masks(P, seed)[mask]
        for frac in (0.0, 0.1, 0.25, 0.4, 0.49):
            ours = R.masked_trimmed_mean(torch.from_numpy(x), m, frac)
            theirs = JR.masked_trimmed_mean(jnp.asarray(x), jnp.asarray(m), frac)
            assert _same(ours, theirs), (seed, frac)
        ours = R.masked_median(torch.from_numpy(x), torch.from_numpy(m))
        assert _same(ours, JR.masked_median(jnp.asarray(x), jnp.asarray(m))), seed


def test_trim_fraction_outside_the_range_is_refused():
    x = torch.zeros(4, 3)
    for frac in (-0.1, 0.5, 0.7):
        with pytest.raises(ValueError, match=r"\[0, 0.5\)"):
            R.masked_trimmed_mean(x, np.ones(4, bool), frac)
    # the trim is clamped so one value survives: 3 members at f = 0.49 keep the middle one
    x = torch.tensor([[3.0], [1.0], [2.0], [100.0]])
    assert R.masked_trimmed_mean(x, [True, True, True, False], 0.49).item() == 2.0


def _krum_bank(P, seed, D=500):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(P, D)).astype(np.float32) + rng.normal(size=D).astype(np.float32)
    x *= (1.0 + np.arange(P, dtype=np.float32) / P)[:, None]  # scores apart
    x[-1] = 10.0 * rng.normal(size=D)  # a far attacker row
    return x


@pytest.mark.parametrize("P", [3, 4, 6, 8])
def test_krum_scores_and_selection_match_the_reference(P):
    for seed in range(3):
        x = _krum_bank(P, seed)
        for f in (None, 0):
            ours = R.krum_scores(torch.from_numpy(x), f).numpy()
            theirs = np.asarray(JR.krum_scores(jnp.asarray(x), f))
            np.testing.assert_allclose(ours, theirs, rtol=1e-5)
            for m in range(1, min(3, P) + 1):
                agg, sel = R.krum_select(torch.from_numpy(x), m=m, f=f)
                jagg, jsel = JR.krum_select(jnp.asarray(x), m=m, f=f)
                assert sel.tolist() == np.asarray(jsel).tolist()
                assert P - 1 not in sel.tolist() or m == P  # the far row is never chosen
                assert _bits(agg, jagg)


def test_krum_refuses_what_the_reference_refuses():
    x = _krum_bank(4, 0)
    for xs, kw, fn, match in ((x[:2], {}, "krum_scores", "at least 3 peers"),
                              (x, dict(f=2), "krum_scores", "outside"),
                              (x, dict(m=0), "krum_select", "outside"),
                              (x, dict(m=5), "krum_select", "outside")):
        with pytest.raises(ValueError, match=match):
            getattr(JR, fn)(jnp.asarray(xs), **kw)
        with pytest.raises(ValueError, match=match):
            getattr(R, fn)(torch.from_numpy(xs), **kw)


def test_norm_clipping_and_flatten_bank_match_the_reference():
    bank = _tree(3, lead=(4,))
    bank["fc.w"][2] *= 40.0  # one scaled-up peer
    jbank = _jax_tree(bank, lead=1)
    np.testing.assert_allclose(R.bank_peer_norms(bank).numpy(),
                               np.asarray(JR.bank_peer_norms(jbank)), rtol=1e-6)
    flat, unflatten = R.flatten_bank(bank)
    jflat, _ = JR.flatten_bank(jbank)
    assert _bits(flat, jflat)
    back = unflatten(flat[1])
    assert all(torch.equal(back[k], bank[k][1]) for k in bank)
    for ours, theirs in ((R.clip_bank_to_norm(bank, 0.5), JR.clip_bank_to_norm(jbank, 0.5)),
                         (R.clip_bank_to_median_norm(bank), JR.clip_bank_to_median_norm(jbank))):
        flat_theirs = dict(zip(convert.jax_order(bank), jax.tree_util.tree_leaves(theirs)))
        for k, v in ours.items():
            np.testing.assert_allclose(convert.to_jax_layout(v, lead=1).numpy(), flat_theirs[k],
                                       rtol=1e-6, atol=1e-7)
    assert (R.bank_peer_norms(R.clip_bank_to_norm(bank, 0.5)) <= 0.5 + 1e-5).all()
    with pytest.raises(ValueError, match="empty"):
        R.bank_peer_norms({})


def test_adversary_spec_is_the_references():
    for seed in range(6):
        for frac in (0.1, 0.25, 0.3, 0.5, 0.75, 1.0):
            ours, theirs = R.AdversarySpec(fraction=frac, seed=seed), JR.AdversarySpec(
                fraction=frac, seed=seed)
            for P in (3, 4, 8, 16, 33):
                assert ours.attackers(P) == theirs.attackers(P)
                assert np.array_equal(ours.mask(P), theirs.mask(P))
                assert [ours.is_attacker(r, P) for r in range(P)] == [
                    theirs.is_attacker(r, P) for r in range(P)]
            assert ours.describe() == theirs.describe() and ours.active == theirs.active
    for num in (0, 1, 3, 9):
        assert R.AdversarySpec(num=num, seed=2).attackers(8) == JR.AdversarySpec(
            num=num, seed=2).attackers(8)
    assert R.ATTACK_KINDS == JR.ATTACK_KINDS
    for kw in (dict(fraction=1.5), dict(attack="meteor"), dict(num=-1)):
        with pytest.raises(ValueError):
            R.AdversarySpec(**kw)


def _reference_normals(key, tree):
    """The reference's scaled_noise draws, leaf by leaf in JAX order."""
    leaves = jax.tree_util.tree_leaves(tree)
    return [np.asarray(jax.random.normal(k, leaf.shape, jnp.float32))
            for k, leaf in zip(jax.random.split(key, len(leaves)), leaves)]


def test_poison_gradients_is_the_references(monkeypatch):
    tree = _tree(5)
    jtree = _jax_tree(tree)
    key = jax.random.PRNGKey(7)
    flip = R.poison_gradients(tree, R.AdversarySpec(num=1, scale=10.0))
    jflip = dict(zip(convert.jax_order(tree), jax.tree_util.tree_leaves(
        JR.poison_gradients(jtree, JR.AdversarySpec(num=1, scale=10.0), key))))
    assert all(_bits(convert.to_jax_layout(flip[k]), jflip[k]) for k in tree)

    spec, jspec = (m.AdversarySpec(num=1, attack="scaled_noise", scale=3.0) for m in (R, JR))
    draws = iter(_reference_normals(key, jtree))
    monkeypatch.setattr(R, "draw_normals", lambda shape, gen: torch.from_numpy(np.array(next(draws))))
    noise = R.poison_gradients(tree, spec, torch.Generator())
    jnoise = dict(zip(convert.jax_order(tree), jax.tree_util.tree_leaves(
        JR.poison_gradients(jtree, jspec, key))))
    assert list(noise) == list(tree)
    assert all(noise[k].shape == tree[k].shape for k in tree)
    assert all(_bits(convert.to_jax_layout(noise[k]), jnoise[k]) for k in tree)
    with pytest.raises(ValueError, match="Generator"):
        R.poison_gradients(tree, spec)
    with pytest.raises(ValueError, match="payload-level"):
        R.poison_gradients(tree, R.AdversarySpec(num=1, attack="stale_replay"))


def test_the_ports_own_noise_is_scaled_standard_normal():
    """Mean within 5 standard errors of 0, standard deviation within 2 % of
    the scale, over 2 x 200,000 draws from a seeded generator."""
    big = {"a": torch.zeros(400, 500), "b": torch.zeros(200_000)}
    noise = R.poison_gradients(big, R.AdversarySpec(num=1, attack="scaled_noise", scale=4.0),
                               torch.Generator().manual_seed(0))
    for v in noise.values():
        assert abs(float(v.mean())) <= 5 * 4.0 / np.sqrt(v.numel())
        assert abs(float(v.std()) / 4.0 - 1.0) <= 0.02


def test_tree_all_finite():
    assert R.tree_all_finite({"a": torch.ones(3), "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert not R.tree_all_finite({"a": torch.tensor([1.0, float("nan")])})
    assert not R.tree_all_finite({"a": torch.tensor([float("-inf")])})


ROBUST = ("trimmed_mean:0.25", "trimmed_mean", "median", "krum", "krum:2")


@pytest.mark.parametrize("clip", [0.0, 2.0])
@pytest.mark.parametrize("graph,wire", [("full", "float32"), ("full", "bfloat16"),
                                        ("ring", "float32")])
def test_robust_combines_match_the_reference_under_vmap(graph, wire, clip):
    P = 5
    bank = _tree(21, lead=(P,))
    bank["fc.w"][3] *= 30.0
    for name in ROBUST:
        proto, jproto = X.get_exchange(name), jget_exchange(name)
        if graph != "full" and proto.requires_full_graph:
            continue
        g, jg = get_graph(graph, P), jget_graph(graph, P)
        mixing = None if graph == "full" else g.mixing_matrix().astype(np.float32)
        kw = dict(num_peers=P, trim_frac=0.2, robust_clip=clip)
        ctx = X.ExchangeContext(wire_dtype=getattr(torch, wire), graph=g, mixing=mixing, **kw)
        jctx = JContext(axis="data", wire_dtype=jnp.dtype(wire), graph=jg, mixing=mixing, **kw)
        ours, state = proto.combine(bank, ctx)
        assert state is None
        theirs = jax.vmap(lambda x: jproto.combine(x, jctx)[0], axis_name="data")(
            _jax_tree(bank, lead=1))
        flat = dict(zip(convert.jax_order(bank), jax.tree_util.tree_leaves(theirs)))
        for k, v in ours.items():
            assert v.shape == bank[k].shape and v.dtype == torch.float32
            ov = convert.to_jax_layout(v, lead=1)
            if clip:
                np.testing.assert_allclose(ov.numpy(), flat[k], rtol=1e-6, atol=1e-7)
            else:
                assert _bits(ov, flat[k]), (name, k)


def test_host_combine_aggregates_the_arrived_ranks_in_order():
    bank = _tree(4, lead=(4,))
    arrived = (2, 0, 3)  # rank 1's contribution was dropped; the list is unsorted
    contribs = [(r, {k: v[r] for k, v in bank.items()}) for r in arrived]
    jpeers = {r: _jax_tree({k: v[r] for k, v in bank.items()}) for r in arrived}
    for name in ROBUST:
        ctx, jctx = X.ExchangeContext(num_peers=4, trim_frac=0.3), JContext(num_peers=4,
                                                                            trim_frac=0.3)
        ours = X.get_exchange(name).host_combine(contribs, 0, ctx)
        theirs = dict(zip(convert.jax_order(bank), jax.tree_util.tree_leaves(
            jget_exchange(name).host_combine(jpeers, 0, jctx))))
        assert all(_bits(convert.to_jax_layout(ours[k]), theirs[k]) for k in bank), name
    assert X.get_exchange("allgather_mean").host_combine(contribs, 0, ctx) is None


# ---------------------------------------------------------------------------
# The host cluster against the reference's
# ---------------------------------------------------------------------------


def _inject_reference_noise(monkeypatch, spec, num_leaves, epochs, attackers):
    """Feed the port the reference's scaled_noise: per epoch and attacker
    (in publish order) the key ``fold_in(fold_in(PRNGKey(seed), epoch),
    rank)`` split once per leaf (simulate.py:359, robust.py:314)."""
    def stream():
        for e in range(epochs):
            for r in attackers:
                pk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(spec.seed), e), r)
                yield from jax.random.split(pk, num_leaves)

    keys = stream()
    monkeypatch.setattr(R, "draw_normals", lambda shape, gen: torch.from_numpy(
        np.array(jax.random.normal(next(keys), tuple(shape), jnp.float32))).to(gen.device))


def _pair(exchange, graph="full", adversary=None, **kw):
    """The reference's and the port's 4-peer squeezenet clusters, same init,
    each with its own package's ``AdversarySpec``."""
    ref = JCluster(
        jget_config("squeezenet1.1"), jmake_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=joptim.sgd(momentum=0.9), exchange=exchange, graph=graph,
        adversary=None if adversary is None else JR.AdversarySpec(**adversary), **COMMON, **kw,
    )
    port = LocalP2PCluster(
        get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
        optimizer=sgd(momentum=0.9), exchange=exchange, graph=graph,
        adversary=None if adversary is None else R.AdversarySpec(**adversary),
        init_params=convert.from_jax(_flatten(ref.peers[0].params), device="cpu"),
        device="cpu", **COMMON, **kw,
    )
    return ref, port


CLUSTER_CASES = {
    "trimmed_sign_flip": dict(exchange="trimmed_mean:0.25", graph="full",
                              adversary=dict(num=1, attack="sign_flip", scale=10.0, seed=1)),
    "median_ring_noise": dict(exchange="median", graph="ring", reject_nonfinite=True,
                              adversary=dict(num=1, attack="scaled_noise", scale=10.0, seed=2)),
    "krum_sign_flip": dict(exchange="krum", graph="full",
                           adversary=dict(fraction=0.25, attack="sign_flip", scale=5.0, seed=3)),
    "stale_replay": dict(exchange="allgather_mean", graph="full", epochs=2,
                         adversary=dict(num=1, attack="stale_replay", seed=2)),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_robust_cluster_epochs_match_the_reference(monkeypatch, case):
    kw = dict(CLUSTER_CASES[case])
    exchange, graph, epochs = kw.pop("exchange"), kw.pop("graph"), kw.pop("epochs", 1)
    adv = kw.pop("adversary")
    ref, port = _pair(exchange, graph, adv, **kw)
    attackers = port.adversary.attackers(4)
    assert sorted(port._attackers) == list(attackers) and attackers
    if adv["attack"] == "scaled_noise":
        _inject_reference_noise(monkeypatch, port.adversary, len(port.names), epochs, attackers)
    for e in range(epochs):
        r_stats, p_stats = ref.run_epoch_sync(e), port.run_epoch_sync(e)
        np.testing.assert_allclose(p_stats["loss"], r_stats["loss"], rtol=1e-5)
    assert _gaps(ref, port).max() <= 1e-5
    _same_accounting(ref, port)
    poisoned = epochs - 1 if adv["attack"] == "stale_replay" else epochs * len(attackers)
    assert port.mailbox.stats["poisoned_publishes"] == poisoned


def test_stale_replay_ships_a_copy_of_the_previous_epochs_payload():
    """Epoch 0 publishes honestly; epoch 1 ships epoch 0's payload, values
    unchanged even when the epoch-0 tensors are written over afterwards."""
    _, port = _pair("allgather_mean", "full", dict(num=1, attack="stale_replay", seed=2))
    (attacker,) = port.adversary.attackers(4)
    port.run_epoch_sync(0)
    assert port.mailbox.stats["poisoned_publishes"] == 0
    _, first = port.mailbox.consume(attacker).payload
    kept = {k: v.clone() for k, v in first.items()}
    for v in first.values():
        v.fill_(123.0)  # an encoder that reuses its output buffers
    port.run_epoch_sync(1)
    assert port.mailbox.stats["poisoned_publishes"] == 1
    _, replayed = port.mailbox.consume(attacker).payload
    assert all(torch.equal(replayed[k], kept[k]) for k in kept)


def test_rejected_nonfinite_contribution_is_dropped_at_consume():
    ref, port = _pair("allgather_mean", "full", reject_nonfinite=True)
    grads = [port._compute_peer_gradient(p, 0)[0] for p in port.peers]
    jgrads = [ref._compute_peer_gradient(p, 0)[0] for p in ref.peers]
    for peer, jpeer in zip(port.peers, ref.peers):
        bad = peer.rank == 3
        port._publish(peer, {k: v * float("nan") for k, v in grads[3].items()} if bad
                      else grads[peer.rank], 0, at_time=0.0)
        ref._publish(jpeer, jax.tree.map(lambda x: x * jnp.nan, jgrads[3]) if bad
                     else jgrads[jpeer.rank], 0, at_time=0.0)
    contribs, _ = port._consume_all(port.peers[0], grads[0], at_time=None)
    jcontribs, _ = ref._consume_all(ref.peers[0], jgrads[0], at_time=None)
    assert [r for r, _ in contribs] == [0, 1, 2] and sorted(jcontribs) == [0, 1, 2]
    assert port.mailbox.stats == ref.mailbox.stats
    assert port.mailbox.stats["rejected_nonfinite"] == 1
    assert port.peers[0].recv_time_s == ref.peers[0].recv_time_s  # the bytes were charged


def test_attackers_own_update_uses_its_poisoned_gradient():
    """Reference behaviour: the attacker's own contribution is the poisoned
    gradient (its ``_publish`` poisons before ``own = grads``, whatever its
    docstring says). On the full graph with ``allgather_mean`` every peer,
    the attacker included, then takes the same mean, each summing from its
    own contribution: the attacker's params are the honest peers' within
    1e-7. Had it kept its honest gradient, its mean would differ from
    theirs by (1 + scale) / P of its gradient."""
    ref, port = _pair("allgather_mean", "full", dict(num=1, attack="sign_flip", scale=10.0, seed=1))
    ref.run_epoch_sync(0)
    port.run_epoch_sync(0)
    for cl in (port, ref):
        params = [convert.to_jax(p.params) if cl is port else _flatten(p.params)
                  for p in cl.peers]
        for other in params[1:]:  # the same mean, summed from another peer's end
            assert max(float(np.abs(other[k] - params[0][k]).max()) for k in params[0]) <= 1e-7
    assert _gaps(ref, port).max() <= 1e-5


def test_under_ef_the_poison_enters_the_attackers_residual():
    """Reference behaviour, under top-k + EF: the attacker encodes its
    poisoned gradient, so its residual is the poisoned gradient off the
    shipped entries (and zero on them), where an honest peer's is its own
    gradient."""
    adv = dict(num=1, attack="sign_flip", scale=10.0, seed=1)
    _, port = _pair("topk", "full", adv, ef=True, topk_frac=0.05)
    (a,) = port.adversary.attackers(4)
    grads = [port._compute_peer_gradient(p, 0)[0] for p in port.peers]
    port.run_epoch_sync(0)
    for peer in port.peers:
        sent = {k: -10.0 * v for k, v in grads[a].items()} if peer.rank == a else grads[peer.rank]
        for k, e in peer.ef.items():
            kept = e != 0
            assert torch.equal(e[kept], sent[k][kept]), (peer.rank, k)
        assert sum(int((e != 0).sum()) for e in peer.ef.values()) > 0


# ---------------------------------------------------------------------------
# The device step against the reference's
# ---------------------------------------------------------------------------

STEP_REFERENCE = textwrap.dedent(
    """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.core.p2p import Topology, TrainState, build_p2p_train_step
    from repro.core.robust import AdversarySpec
    from repro.core.simulate import cnn_loss
    from repro.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro.models import init_model
    from repro.optim import sgd
    from repro.train.checkpoint import _flatten

    out_path, peers, lr, steps = sys.argv[1], 4, 0.05, 2
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8,
                              image_channels=1, num_classes=ds.num_classes)
    params = init_model(jax.random.PRNGKey(0), cfg)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, peers * 8)
    batches = [loader.load(BatchKey(0, 0, i)) for i in range(steps)]
    out = {f"init/{k}": v for k, v in _flatten(params).items()}
    for i, b in enumerate(batches):
        out[f"batch{i}/images"], out[f"batch{i}/labels"] = b["images"], b["labels"]
    mesh = compat.make_mesh((peers,), ("data",), axis_types=(compat.AxisType.Auto,))
    opt = sgd(momentum=0.9)
    topo = Topology(peer_axes=("data",), lambda_axis=None, exchange="trimmed_mean:0.25")
    step = jax.jit(build_p2p_train_step(
        lambda p, b: cnn_loss(p, b, cfg), opt, topo, mesh, lambda s: lr,
        adversary=AdversarySpec(num=1, attack="sign_flip", scale=10.0, seed=1)))
    st = TrainState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32),
                    key=jax.random.PRNGKey(0))
    losses = []
    with compat.set_mesh(mesh):
        for b in batches:
            st, m = step(st, jax.tree.map(jnp.asarray, b))
            losses.append(float(m["loss"]))
    out.update({f"params/{k}": v for k, v in _flatten(st.params).items()})
    out.update({f"momentum/{k}": v for k, v in _flatten(st.opt_state).items()})
    out["loss"] = np.asarray(losses)
    np.savez(out_path, **out)
    print("OK")
    """
)


def test_trimmed_mean_step_with_a_sign_flip_attacker_matches_the_reference(tmp_path):
    path = tmp_path / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", STEP_REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    with np.load(path) as npz:
        data = dict(npz)
    part = lambda prefix: {k[len(prefix) + 1:]: v for k, v in data.items()
                           if k.startswith(prefix + "/")}

    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=ds.num_classes)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu").requires_grad_(False)
    opt = sgd(momentum=0.9)
    step = p2p.build_p2p_train_step(
        lambda p, b: cnn_loss(model, p, b["images"], b["labels"]), opt,
        p2p.Topology(exchange="trimmed_mean:0.25"), 4, lambda s: 0.05,
        adversary=R.AdversarySpec(num=1, attack="sign_flip", scale=10.0, seed=1), device="cpu")
    params = convert.from_jax(part("init"), device="cpu")
    state = p2p.TrainState(params, opt.init(params), 0, None)
    losses = []
    for i in range(2):
        b = part(f"batch{i}")
        state, metrics = step(state, {"images": models.images_to_device(b["images"], "cpu"),
                                      "labels": torch.from_numpy(b["labels"].astype(np.int64))})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, data["loss"], rtol=1e-5)
    for ours, theirs in ((convert.to_jax(state.params), part("params")),
                         (convert.opt_state_to_jax(state.opt_state), part("momentum"))):
        assert sorted(ours) == sorted(theirs)
        gaps = np.concatenate([np.abs(ours[k] - theirs[k]).reshape(-1) for k in theirs])
        assert gaps.max() <= 10.0 * 1e-5  # scale x the gradients' gap
        assert (gaps > 1e-5).sum() <= 1e-4 * gaps.size


def _linear_step(topo, adversary, peers=5):
    """A step whose per-peer gradient is known: loss = sum(w * x) over a
    peer's rows, so peer r's gradient is its rows' sum."""
    step = p2p.build_p2p_train_step(lambda p, b: ((p["w"] * b["x"]).sum(), b["x"].sum()), sgd(),
                                    topo, peers, lambda s: 1.0, adversary=adversary, device="cpu")
    x = torch.randn(peers, 1000, generator=torch.Generator().manual_seed(1)) * 0.01 + 1.0
    return step, x


def test_device_step_noise_attacker_draws_from_the_state_generator():
    """allgather_mean with a scaled_noise attacker: the update is the mean of
    the honest rows and the attacker's noise, which is scale x N(0, 1)
    (statistically); without a generator in the state the step refuses."""
    adv = R.AdversarySpec(num=1, attack="scaled_noise", scale=3.0, seed=0)
    step, x = _linear_step(p2p.Topology(), adv)
    (a,) = adv.attackers(5)
    state = p2p.TrainState({"w": torch.zeros(1000)}, {}, 0, torch.Generator().manual_seed(0))
    new, _ = step(state, {"x": x})
    noise = -5 * new.params["w"] - (x.sum(0) - x[a])
    assert abs(float(noise.mean())) <= 5 * 3.0 / np.sqrt(1000)
    assert abs(float(noise.std()) / 3.0 - 1.0) <= 0.1
    with pytest.raises(ValueError, match="Generator"):
        step(state.replace(key=None), {"x": x})


@pytest.mark.parametrize("exchange", ["krum", "median", "trimmed_mean:0.25"])
def test_device_step_robust_protocols_reject_the_attacker(exchange):
    """With a sign_flip attacker (scale 10) among 5 peers, the robust
    update stays within the honest rows' range, where the plain mean is
    dragged far outside it."""
    adv = R.AdversarySpec(num=1, attack="sign_flip", scale=10.0, seed=0)
    (a,) = adv.attackers(5)
    honest = [r for r in range(5) if r != a]
    for name, robust in ((exchange, True), ("allgather_mean", False)):
        step, x = _linear_step(p2p.Topology(exchange=name), adv)
        new, _ = step(p2p.TrainState({"w": torch.zeros(1000)}, {}, 0, None), {"x": x})
        g = -new.params["w"]
        inside = bool(((g >= x[honest].min(0).values - 1e-6)
                       & (g <= x[honest].max(0).values + 1e-6)).all())
        assert inside == robust, name

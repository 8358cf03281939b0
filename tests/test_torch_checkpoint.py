"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's ``repro/train/checkpoint.py``, on the CPU.

* Twins of ``tests/test_infra.py``'s checkpoint tests and of
  ``tests/test_exchange.py::test_checkpoint_versioning`` on the port's
  trees and TrainState.
* Checkpoints cross both ways: a v1 params checkpoint and a v2 state
  (Adam's moments, the step, the key, the EF bank; SGD momentum; the async
  mailbox) written by one package restore in the other bit for bit, for a
  reduced LM (the stacked ``stack``/``tail`` layout) and a CNN (HWIO
  convolutions). The files hold the same npz keys and shapes.
* Reference behaviour 22: the port writes ``key`` as
  ``jax.random.PRNGKey(seed)``'s bits and its generator's whole state
  beside it, restores that state exactly, and seeds its generator from a
  reference key's 64 bits.
* A ``PeerBank`` state is written as peer 0's copy and restored into every
  row; missing keys and shape mismatches raise the reference's
  ``ValueError`` messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.p2p import TrainState as JTrainState
from repro.core.p2p import init_ef as jinit_ef
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro.train import checkpoint as jck
from repro.train.steps import init_train_state as jinit_train_state
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.p2p import PeerBank, TrainState, init_ef, init_mailbox, peer_bank
from repro_torch.optim import adam, sgd
from repro_torch.train import checkpoint as ck
from repro_torch.train import init_train_state

torch.set_num_threads(2)  # the test workers share the CPU with each other

PEERS = 2


# ---------------------------------------------------------------------------
# twins of the reference's checkpoint tests
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.int32),
                   "c": [torch.zeros(()), torch.ones((2, 2))]},
    }
    path = str(tmp_path / "ck")
    ck.save(path, tree, step=42, extra={"note": "x"})
    like = {"a": torch.zeros(3, 4), "nested": {"b": torch.zeros(5, dtype=torch.int32),
                                                "c": [torch.ones(()), torch.zeros(2, 2)]}}
    back, meta = ck.restore(path, like)
    assert meta["step"] == 42 and meta["note"] == "x" and meta["format"] == ck.V1_FORMAT
    assert torch.equal(back["a"], tree["a"]) and back["nested"]["b"].dtype == torch.int32
    assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
    for a, b in zip(back["nested"]["c"], tree["nested"]["c"]):
        assert torch.equal(a, b)
    # the reference reads the port's file into the same structure
    jback, jmeta = jck.restore(path, jax.tree.map(jnp.zeros_like, {
        "a": jnp.zeros((3, 4)), "nested": {"b": jnp.zeros(5, jnp.int32),
                                            "c": [jnp.zeros(()), jnp.zeros((2, 2))]}}))
    np.testing.assert_array_equal(np.asarray(jback["a"]), tree["a"].numpy())
    assert jmeta["step"] == 42


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_checkpoint_shape_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    ck.save(path, {"a": torch.ones((2, 2))})
    ours = _message(lambda: ck.restore(path, {"a": torch.ones((3, 3))}))
    theirs = _message(lambda: jck.restore(path, {"a": jnp.ones((3, 3))}))
    assert ours == theirs == "a: shape (2, 2) != (3, 3)"


def test_checkpoint_missing_key(tmp_path):
    path = str(tmp_path / "ck")
    ck.save(path, {"a": torch.ones((2,))})
    ours = _message(lambda: ck.restore(path, {"a": torch.ones((2,)), "b": torch.ones((2,))}))
    theirs = _message(lambda: jck.restore(path, {"a": jnp.ones((2,)), "b": jnp.ones((2,))}))
    assert ours == theirs == "checkpoint missing keys: ['b'] ..."


def test_checkpoint_versioning(tmp_path):
    state = TrainState(params={"w": torch.arange(4.0)},
                       opt_state={"momentum": {"w": torch.ones(4)}},
                       step=7, key=torch.Generator().manual_seed(0))
    # v2: full state roundtrip
    p2 = str(tmp_path / "state_v2")
    ck.save_state(p2, state)
    like = TrainState(params={"w": torch.zeros(4)}, opt_state={"momentum": {"w": torch.zeros(4)}},
                      step=0, key=torch.Generator().manual_seed(5))
    back, meta = ck.restore_state(p2, like)
    assert meta["format"] == ck.STATE_FORMAT and meta["step"] == 7
    assert torch.equal(back.params["w"], torch.arange(4.0)) and back.step == 7
    # a sync-protocol v2 checkpoint restores into an async `like`: the cold
    # mailbox ring from `like` is kept, everything else comes from disk
    ring = {"w": torch.zeros((1, 2, 4))}
    back_a, _ = ck.restore_state(p2, like.replace(mailbox=ring))
    assert torch.equal(back_a.params["w"], torch.arange(4.0)) and back_a.mailbox is ring
    # v1 (params only) restores into .params and keeps the rest fresh
    p1 = str(tmp_path / "params_v1")
    ck.save(p1, state.params, step=3)
    like = like.replace(key=torch.Generator().manual_seed(5))
    back1, meta1 = ck.restore_state(p1, like)
    assert torch.equal(back1.params["w"], torch.arange(4.0)) and meta1["step"] == 3
    assert back1.step == 0  # from `like`, not the checkpoint
    assert float(back1.opt_state["momentum"]["w"][0]) == 0.0
    assert back1.key.initial_seed() == 5
    # the reference reads the port's v2 file as its own TrainState
    jlike = JTrainState(params={"w": jnp.zeros(4)}, opt_state={"momentum": {"w": jnp.zeros(4)}},
                        step=jnp.int32(0), key=jax.random.PRNGKey(9))
    jback, jmeta = jck.restore_state(p2, jlike)
    np.testing.assert_array_equal(np.asarray(jback.params["w"]), np.arange(4.0))
    assert int(jback.step) == 7 and jmeta["format"] == jck.STATE_FORMAT


# ---------------------------------------------------------------------------
# crossing between the packages: a reduced LM and a CNN
# ---------------------------------------------------------------------------

MODELS = {  # name -> (reference config, port config)
    "qwen2.5-3b": (jreduced(jget_config("qwen2.5-3b"), num_layers=3),
                   reduced(get_config("qwen2.5-3b"), num_layers=3)),
    "gemma2-2b": (jreduced(jget_config("gemma2-2b"), num_layers=3),
                  reduced(get_config("gemma2-2b"), num_layers=3)),
    "squeezenet1.1": (jget_config("squeezenet1.1"), get_config("squeezenet1.1")),
}


def _port_params(name, jparams):
    _, cfg = MODELS[name]
    flat = jck._flatten(jparams)
    if cfg.family == "cnn":
        return convert.from_jax(flat, device="cpu")
    return convert.lm_from_jax(flat, cfg, device="cpu")


def _reference_state(name, opt, *, ef: bool, seed=0):
    """A reference TrainState with every leaf distinct from its init (so
    that a restore that kept ``like``'s value shows)."""
    jcfg, _ = MODELS[name]
    key = jax.random.PRNGKey(seed)
    if jcfg.family == "cnn":
        params = jmodels.init_model(key, jcfg)
        state = JTrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0),
                            key=jax.random.fold_in(key, 1))
    else:
        state = jinit_train_state(key, jcfg, opt)
    bump = lambda t: jax.tree.map(lambda x: x + jnp.asarray(1.25, x.dtype), t)
    state = state.replace(opt_state=bump(state.opt_state), step=jnp.int32(11))
    if ef:
        state = state.replace(ef=bump(jinit_ef(state.params, PEERS)))
    return state


def _port_like(name, opt, *, ef: bool):
    _, cfg = MODELS[name]
    state = init_train_state(torch.Generator().manual_seed(7), cfg, opt, device="cpu")
    return state.replace(ef=init_ef(state.params, PEERS)) if ef else state


def _same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _npz(path):
    with np.load(path + ".npz") as npz:
        return {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_v1_params_cross_both_ways(tmp_path, name):
    jcfg, cfg = MODELS[name]
    jparams = _reference_state(name, jadam(), ef=False).params
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_path, jparams, step=4)
    like = _port_like(name, adam(), ef=False).params
    params, meta = ck.restore(ref_path, like, cfg=cfg)
    want = _port_params(name, jparams)
    assert meta["step"] == 4 and all(torch.equal(params[k], want[k]) for k in want)
    ck.save(port_path, params, step=4, cfg=cfg)
    _same_flat(_npz(port_path), _npz(ref_path))
    jback, _ = jck.restore(port_path, jax.tree.map(jnp.zeros_like, jparams))
    _same_flat(jck._flatten(jback), jck._flatten(jparams))


@pytest.mark.parametrize("optimizer", ["adam", "sgd_momentum"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_v2_states_cross_both_ways(tmp_path, name, optimizer):
    jcfg, cfg = MODELS[name]
    jopt, opt = (jadam(), adam()) if optimizer == "adam" else (jsgd(momentum=0.9), sgd(momentum=0.9))
    jstate = _reference_state(name, jopt, ef=True)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_state(ref_path, jstate)
    state, meta = ck.restore_state(ref_path, _port_like(name, opt, ef=True), cfg=cfg)
    assert meta["format"] == ck.STATE_FORMAT and state.step == 11
    want = _port_params(name, jstate.params)
    assert all(torch.equal(state.params[k], want[k]) for k in want)
    moments = convert.opt_state_from_jax(jck._flatten(jstate.opt_state), device="cpu",
                                         cfg=None if cfg.family == "cnn" else cfg)
    for k, t in (moments["mu"] if optimizer == "adam" else moments).items():
        got = state.opt_state["mu"][k] if optimizer == "adam" else state.opt_state[k]
        assert torch.equal(got, t), k
    if optimizer == "adam":
        assert int(state.opt_state["t"]) == int(jstate.opt_state["t"]) == 1
    ef_rows = [_port_params(name, jax.tree.map(lambda x: x[r], jstate.ef)) for r in range(PEERS)]
    for k, t in state.ef.items():
        assert t.shape[0] == PEERS and all(torch.equal(t[r], ef_rows[r][k]) for r in range(PEERS))
    # and back: the same npz the reference wrote, but for the port's extra entry
    ck.save_state(port_path, state, cfg=cfg)
    ours = _npz(port_path)
    assert ck.GENERATOR_STATE in ours
    ours.pop(ck.GENERATOR_STATE)
    _same_flat(ours, _npz(ref_path))
    jback, _ = jck.restore_state(port_path, jax.tree.map(jnp.zeros_like, jstate))
    _same_flat(jck._flatten(jback), jck._flatten(jstate))


def test_async_mailbox_crosses_both_ways(tmp_path):
    """The async ring {name: (K, P, ...)} of a CNN, in HWIO inside."""
    jcfg, cfg = MODELS["squeezenet1.1"]
    jstate = _reference_state("squeezenet1.1", jsgd(momentum=0.9), ef=False)
    K = 2
    ring = jax.tree.map(lambda p: jnp.broadcast_to(p, (K, PEERS) + p.shape) * jnp.arange(
        1, K * PEERS + 1, dtype=p.dtype).reshape((K, PEERS) + (1,) * p.ndim), jstate.params)
    jstate = jstate.replace(mailbox=ring)
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save_state(ref_path, jstate)
    like = _port_like("squeezenet1.1", sgd(momentum=0.9), ef=False)
    like = like.replace(mailbox=init_mailbox(like.params, PEERS, staleness=K))
    state, _ = ck.restore_state(ref_path, like, cfg=cfg)
    for k, t in state.mailbox.items():
        for s in range(K):
            for r in range(PEERS):
                want = _port_params("squeezenet1.1", jax.tree.map(lambda x: x[s, r], ring))[k]
                assert torch.equal(t[s, r], want), (k, s, r)
    ck.save_state(port_path, state, cfg=cfg)
    ours = _npz(port_path)
    ours.pop(ck.GENERATOR_STATE)
    _same_flat(ours, _npz(ref_path))


def test_port_state_restores_in_the_port(tmp_path):
    """A port state written and read by the port: every leaf equal, the
    generator's stream continues where it was (behaviour 22), and a
    PeerBank state comes back in every row from peer 0's copy."""
    _, cfg = MODELS["qwen2.5-3b"]
    state = _port_like("qwen2.5-3b", adam(), ef=True).replace(step=3)
    torch.rand(5, generator=state.key)  # advance the stream past its seed
    path = str(tmp_path / "port")
    ck.save_state(path, state, cfg=cfg)
    expected = torch.rand(4, generator=torch.Generator().set_state(state.key.get_state()))
    like = _port_like("qwen2.5-3b", adam(), ef=True)
    back, _ = ck.restore_state(path, like, cfg=cfg)
    assert back.step == 3 and torch.equal(torch.rand(4, generator=back.key), expected)
    for k in state.params:
        assert torch.equal(back.params[k], state.params[k])
        assert torch.equal(back.ef[k], state.ef[k])
    banked = state.replace(**dict(zip(("params", "opt_state"),
                                      peer_bank(state.params, state.opt_state, PEERS))))
    banked.params[next(iter(banked.params))][1].add_(1.0)  # peer 1 differs; peer 0's is saved
    ck.save_state(path, banked, cfg=cfg)
    _same_flat({k: v for k, v in _npz(path).items() if k.startswith("params/")},
               {f"params/{k}": v for k, v in convert.lm_to_jax(state.params, cfg).items()})
    like = _port_like("qwen2.5-3b", adam(), ef=True)
    like = like.replace(**dict(zip(("params", "opt_state"),
                                   peer_bank(like.params, like.opt_state, PEERS))))
    back, _ = ck.restore_state(path, like, cfg=cfg)
    assert isinstance(back.params, PeerBank) and isinstance(back.opt_state["mu"], PeerBank)
    for k, t in back.params.items():
        assert all(torch.equal(t[r], state.params[k]) for r in range(PEERS))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_key_is_the_references_raw_key_and_seeds_the_generator(tmp_path, seed):
    """Reference behaviour 22. A port generator seeded with s writes
    ``jax.random.PRNGKey(s)``; a reference key restores as a generator
    seeded with its 64 bits (and writes the same key back)."""
    _, cfg = MODELS["qwen2.5-3b"]
    state = _port_like("qwen2.5-3b", adam(), ef=False).replace(key=torch.Generator().manual_seed(seed))
    path = str(tmp_path / "port")
    ck.save_state(path, state, cfg=cfg)
    key = _npz(path)["key"]
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    jstate = _reference_state("qwen2.5-3b", jadam(), ef=False, seed=seed)
    ref_path = str(tmp_path / "ref")
    jck.save_state(ref_path, jstate)
    back, _ = ck.restore_state(ref_path, _port_like("qwen2.5-3b", adam(), ef=False), cfg=cfg)
    hi, lo = (int(x) for x in np.asarray(jstate.key))
    assert back.key.initial_seed() == (hi << 32) | lo
    assert torch.equal(torch.rand(3, generator=back.key),
                       torch.rand(3, generator=torch.Generator().manual_seed((hi << 32) | lo)))
    ck.save_state(path, back, cfg=cfg)
    np.testing.assert_array_equal(_npz(path)["key"], np.asarray(jstate.key))


def test_shape_mismatch_in_a_state_raises(tmp_path):
    _, cfg = MODELS["qwen2.5-3b"]
    path = str(tmp_path / "port")
    ck.save_state(path, _port_like("qwen2.5-3b", adam(), ef=False), cfg=cfg)
    wider = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    like = init_train_state(torch.Generator().manual_seed(0), wider, adam(), device="cpu")
    with pytest.raises(ValueError, match=r"params/stack/0/ffn/w_down: shape"):
        ck.restore_state(path, like, cfg=wider)

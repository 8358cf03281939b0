"""The port's MoE layer and MoE LMs against the reference's, on the CPU.

Models: granite-moe-3b-a800m, moonshot-v1-16b-a3b (its always-on shared
expert) and dbrx-132b, each ``reduced`` to 2 layers (4 experts, top 2),
weights a seeded numpy fill of every reference leaf
(``test_torch_train_steps.fill_params``: a router or an expert bank like a
linear, normal / sqrt(fan-in)) carried across by ``convert.lm_from_jax``.

Tolerances, in f32 compute (``dtype="float32"``): XLA and PyTorch sum the
products in other orders, about 1e-7 relative. That moves a router
probability by far less than the gap between any token's k-th and
(k+1)-th probability here (each test that compares routed outputs
requires a gap above 1e-4 first), so both sides route every token to the
same experts and the layers agree within 1e-5 (``moe_apply``), the logits
within atol 1e-4 and rtol 1e-4, the aux loss within rtol 1e-5, and each
gradient leaf within 1e-4 of its largest magnitude. ``router_topk`` agrees
within rtol 1e-6. The capacity dispatch drops the pairs past an expert's
C slots, so the two dispatches agree only where nothing drops: each is held
to the same dispatch of the reference, the drops included.

Two ``build_train_step`` steps of reduced granite (remat on) are held to
the reference's 2-device step in ``test_torch_train_steps``' subprocess
harness, the few coordinates that Adam's eps leaves apart after the first
step set to the reference's before the second (reference behaviour 25);
four free-running steps at the reference CLI's rate on one fixed batch
follow the reference's losses.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as JL
from repro.train import checkpoint as jck
from repro.train.checkpoint import _flatten
from repro.train.steps import lm_loss as jlm_loss
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM
from repro_torch.train import checkpoint as ck
from repro_torch.train import lm_loss
from test_torch_train_steps import fill_params, hold_steps_to_reference, run_reference_steps

torch.set_num_threads(2)  # the test workers share the CPU with each other

B, S, GEN = 2, 24, 8
ARCHS = ("dbrx-132b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
DISPATCHES = ("dense", "capacity")


def _cfgs(arch, dtype="float32", **kw):
    kw = dict(dict(num_layers=2, dtype=dtype), **kw)
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


@functools.lru_cache(maxsize=None)
def _pair(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = fill_params(jcfg)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(jparams), cfg, device="cpu"))
    return jcfg, cfg, jparams, model.requires_grad_(False)


def _tokens(n, vocab, seed=1, rows=B):
    return np.random.default_rng(seed).integers(0, vocab, size=(rows, n)).astype(np.int32)


def _margin(probs, k):
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    top = np.sort(np.asarray(probs).reshape(-1, probs.shape[-1]), axis=-1)[:, ::-1]
    return float((top[:, k - 1] - top[:, k]).min())


def _layer0_ffn(jparams):
    return jax.tree.map(lambda a: a[0], jparams["stack"][0]["ffn"])


def test_router_topk_matches_reference():
    logits = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32) * 2
    w = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    for k in (1, 2, 3, 8):
        jg, jaux, jp = JL.router_topk(jnp.asarray(logits), k)
        g, aux, p = L.router_topk(torch.from_numpy(logits), k)
        assert k == 8 or _margin(jp, k) > 1e-4
        np.testing.assert_array_equal((g > 0).numpy(), np.asarray(jg) > 0)
        np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        # the gradient through the gates and the aux loss
        jgrad = jax.grad(lambda x: jnp.sum(JL.router_topk(x, k)[0] * w) + JL.router_topk(x, k)[1])(
            jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        gates, aux, _ = L.router_topk(x, k)
        (gates * torch.from_numpy(w)).sum().add(aux).backward()
        np.testing.assert_allclose(x.grad.numpy(), jgrad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("chunk", [4096, 16])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dispatch, chunk):
    """One MoE layer's params on random activations; chunks of 16 tokens
    run the dense dispatch's loop over 3 chunks of the 48 tokens."""
    jcfg, cfg, jparams, model = _pair(arch)
    x = np.random.default_rng(2).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jp = _layer0_ffn(jparams)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model) @ jp["router"], -1)
    assert _margin(probs, cfg.experts_per_token) > 1e-4
    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), jcfg, dispatch=dispatch, token_chunk=chunk)
    y, aux = L.moe_apply(model.layers[0].ffn, torch.from_numpy(x), cfg, dispatch=dispatch,
                         token_chunk=chunk)
    assert y.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_capacity_dispatch_drops_as_the_reference_does(factor):
    """Tokens pulled towards some experts (8 input dims shifted by 2)
    overflow their C slots: the pairs past C are dropped on both sides, an
    expert's first C routed tokens kept, in token order."""
    jcfg, cfg, jparams, model = _pair("granite-moe-3b-a800m")
    x = np.random.default_rng(3).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    x[..., :8] += 2.0
    jp = _layer0_ffn(jparams)
    T, E, k = B * S, cfg.num_experts, cfg.experts_per_token
    gates, _, probs = JL.router_topk(jnp.asarray(x).reshape(T, -1) @ jp["router"], k)
    assert _margin(probs, k) > 1e-4
    C = int(np.ceil(k * T / E * factor))
    routed = (np.asarray(gates) > 0).sum(0)
    assert routed.max() > C, f"no expert overflows its {C} slots: {routed}"
    jy, _ = JL.moe_apply(jp, jnp.asarray(x), jcfg, dispatch="capacity", capacity_factor=factor)
    y, _ = L.moe_apply(model.layers[0].ffn, torch.from_numpy(x), cfg, dispatch="capacity",
                       capacity_factor=factor)
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-5, rtol=1e-5)
    dense, _ = L.moe_apply(model.layers[0].ffn, torch.from_numpy(x), cfg, dispatch="dense")
    assert float((dense - y).abs().max()) > 1e-2  # the drops show


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg, dispatch):
    return jax.jit(lambda p, t: jmodels.forward(p, {"tokens": t}, jcfg, moe_dispatch=dispatch))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f32(arch, dispatch):
    jcfg, cfg, jparams, model = _pair(arch)
    tokens = _tokens(S, cfg.vocab_size)
    jlogits, jaux = _jit_forward(jcfg, dispatch)(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        logits, aux = models.forward(model, {"tokens": tokens}, cfg, moe_dispatch=dispatch)
    assert logits.shape == (B, S, cfg.vocab_size) and float(aux) > 0
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _reference_serve(jcfg, jparams, tokens, dispatch):
    state = jmodels.init_decode_state(jcfg, B, tokens.shape[1] + GEN)
    logits, state = jax.jit(lambda p, s, t: jmodels.prefill(p, s, {"tokens": t}, jcfg,
                                                            moe_dispatch=dispatch))(
        jparams, state, jnp.asarray(tokens))
    step = jax.jit(lambda p, s, t: jmodels.decode_step(p, s, t, jcfg, moe_dispatch=dispatch))
    first, toks, steps = np.asarray(logits), [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        toks.append(np.asarray(tok)[:, 0])
        logits, state = step(jparams, state, tok)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return first, jax.tree.map(np.asarray, state), np.stack(toks, 1), steps


@pytest.mark.parametrize("arch,dispatch", [(a, "dense") for a in ARCHS]
                         + [("granite-moe-3b-a800m", "capacity")])
def test_prefill_and_greedy_decode_match_reference_f32(arch, dispatch):
    jcfg, cfg, jparams, model = _pair(arch)
    tokens = _tokens(S, cfg.vocab_size, seed=4)
    jfirst, jstate, jtoks, jsteps = _reference_serve(jcfg, jparams, tokens, dispatch)
    with torch.no_grad():
        state = models.init_decode_state(cfg, B, S + GEN, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg, moe_dispatch=dispatch)
        np.testing.assert_allclose(logits.numpy(), jfirst, atol=1e-4, rtol=1e-4)
        toks, steps = [], []
        tok = logits.argmax(-1)[:, None]
        for _ in range(GEN):
            toks.append(tok[:, 0].numpy())
            logits, state = models.decode_step(model, state, tok, cfg, moe_dispatch=dispatch)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)[:, None]
    np.testing.assert_array_equal(np.stack(toks, 1), jtoks)
    for ours, theirs in zip(steps, jsteps):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)
    for layer, cache in enumerate(state["layers"]):  # period 1: layer g is group g of slot 0
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(), jstate["layers"][0][name][layer],
                                       atol=1e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(jcfg, dispatch):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, jcfg, moe_dispatch=dispatch), has_aux=True))


def _batch(cfg, rows=B, seed=5):
    toks = _tokens(S + 1, cfg.vocab_size, seed=seed, rows=rows)
    return toks[:, :-1], toks[:, 1:]


def _hold_grads(grads, jgrads, cfg):
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{cfg.name} {name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b"])
def test_lm_loss_and_gradients_match_reference(arch, dispatch, remat):
    """The loss with its router aux term (``router_aux_coef`` x the layers'
    aux), and every gradient, the router's through the aux too; with remat
    each layer is a ``RecomputeGroupFn`` whose aux output has a gradient."""
    jcfg, cfg = _cfgs(arch, remat=remat)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg)
    (jloss, jce), jgrads = _reference_value_and_grad(jcfg, dispatch)(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    grads, (loss, ce) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg, moe_dispatch=dispatch), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    _, jaux = _jit_forward(jcfg, dispatch)(jparams, jnp.asarray(tokens))
    assert float(loss) - float(ce) > cfg.router_aux_coef * float(jaux)  # aux and z-loss terms
    _hold_grads(grads, jgrads, cfg)
    assert float(grads["layers.0.ffn.router.weight"].abs().max()) > 0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_per_peer_gradients_under_vmap_match_reference(dispatch, remat):
    """``vmap(grad)`` over 2 peers, as the per-peer device step takes it:
    the capacity dispatch's max-scatter, gathers and ``index_add`` under
    vmap, and the remat Function's aux output, against the reference's
    ``jax.vmap(jax.grad)``."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", remat=remat)
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg, rows=2 * B, seed=6)
    split = lambda a: a.reshape(2, B, -1)
    jgrads = jax.jit(jax.vmap(jax.grad(lambda p, b: jlm_loss(p, b, jcfg, moe_dispatch=dispatch)[0]),
                              in_axes=(None, 0)))(
        jparams, {"tokens": jnp.asarray(split(tokens)), "labels": jnp.asarray(split(labels))})
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    batch = {"tokens": torch.from_numpy(split(tokens)).long(),
             "labels": torch.from_numpy(split(labels)).long()}
    grads = torch.func.vmap(torch.func.grad(
        lambda p, b: lm_loss(model, p, b, cfg, moe_dispatch=dispatch)[0]), in_dims=(None, 0))(
        params, batch)
    for peer in range(2):
        _hold_grads({k: g[peer] for k, g in grads.items()},
                    jax.tree.map(lambda a: a[peer], jgrads), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_and_checkpoints_cross_both_ways(tmp_path, arch):
    """``convert`` keeps an expert bank's (E, d, f) layout and transposes
    the router and the shared expert's linears; a v1 params npz written by
    either package restores in the other, the same bits."""
    jcfg, cfg = _cfgs(arch, dtype="bfloat16")
    jparams = fill_params(jcfg, seed=7)
    flat = _flatten(jparams)
    ported = convert.lm_from_jax(flat, cfg, device="cpu")
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(ported) == sorted(model.state_dict())
    model.load_state_dict(ported)
    bank = ported["layers.1.ffn.w_down"]
    assert bank.shape == (cfg.num_experts, cfg.d_ff, cfg.d_model)
    assert torch.equal(bank, torch.from_numpy(flat["stack/0/ffn/w_down"][1].copy()))
    assert torch.equal(ported["layers.0.ffn.router.weight"],
                       torch.from_numpy(flat["stack/0/ffn/router"][0].T.copy()))
    if cfg.moe_shared_ff:
        assert ported["layers.0.ffn.shared.w_up.weight"].shape == (cfg.moe_shared_ff, cfg.d_model)
    for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k])
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jck.save(ref_path, jparams, step=3)
    params, meta = ck.restore(ref_path, dict(model.named_parameters()), cfg=cfg)
    assert meta["step"] == 3 and all(torch.equal(params[k], ported[k]) for k in ported)
    ck.save(port_path, params, step=3, cfg=cfg)
    jback, _ = jck.restore(port_path, jax.tree.map(jnp.zeros_like, jparams))
    for k, a in _flatten(jback).items():
        np.testing.assert_array_equal(a, flat[k])


def test_two_train_steps_match_reference(tmp_path, monkeypatch):
    """Two ``build_train_step`` steps of reduced granite with remat, the
    dense dispatch (the reference trainer's default), against the
    reference's 2-device step (``test_torch_train_steps``' harness and
    tolerances). The first step leaves a few dozen coordinates up to lr
    from the reference's, each with a gradient within 2e-5 of its leaf's
    largest (reference behaviour 25); they take the reference's values
    before the second step (``settle``), and the rest runs on from the
    port's own state. No router flip is behind them: on the second step's
    batch and the reference's state before it, every token's k-th and
    (k+1)-th router probabilities lie more than 1e-4 apart in each layer."""
    reference = run_reference_steps(tmp_path, "granite-moe-3b-a800m", remat=True)
    cfg = reduced(get_config("granite-moe-3b-a800m"), dtype="float32", remat=True)
    hold_steps_to_reference(reference, cfg, settle=True)
    probs, router_topk = [], L.router_topk
    monkeypatch.setattr(L, "router_topk", lambda logits, k: probs.append(
        torch.softmax(logits, -1)) or router_topk(logits, k))
    model = LM(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(reference("step0/params"), cfg, device="cpu"))
    with torch.no_grad():
        models.forward(model, {"tokens": torch.from_numpy(reference("batch1")[:, :-1]).long()}, cfg)
    assert len(probs) == cfg.num_layers
    assert min(_margin(p, cfg.experts_per_token) for p in probs) > 1e-4


def test_free_steps_at_the_cli_rate_follow_the_reference(tmp_path):
    """Reduced granite with remat, from ``init_train_state``'s own weights,
    four free-running steps on one fixed batch under ``warmup_cosine(3e-3,
    1, 4)`` (the reference CLI's rate, as ``chip_smoke.py``'s train paths
    schedule it): each step's loss within rtol 1e-5 of the reference's
    (both sides' trajectories drift apart through reference behaviour 25,
    unsettled here)."""
    from repro_torch.core.p2p import Topology, TrainState
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train import build_train_step

    schedule = (3e-3, 1, 4)
    reference = run_reference_steps(tmp_path, "granite-moe-3b-a800m", steps=4, schedule=schedule,
                                    fill=False, fixed=True, remat=True)
    cfg = reduced(get_config("granite-moe-3b-a800m"), dtype="float32", remat=True)
    state = TrainState(
        params=convert.lm_from_jax(reference("init/params"), cfg, device="cpu"),
        opt_state=convert.opt_state_from_jax(reference("init/opt"), device="cpu", cfg=cfg),
        step=0, key=None)
    step = build_train_step(cfg, adam(), Topology(), 2, warmup_cosine(*schedule), device="cpu")
    toks = torch.from_numpy(reference("batch0")).long()
    losses = []
    for _ in range(4):
        state, metrics = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, reference("loss"), rtol=1e-5)


def test_a_groups_aux_is_its_last_layers_as_in_the_reference():
    """Reference behaviour 24: the reference's scanned group body adds only
    the aux of its period's last layer (``(h, aux + a)`` after the loop over
    the period), the tail layers each their own. Every MoE config has a
    period of one layer, where that is every layer's; on a period of two
    (gemma2's local/global pattern with experts) the port adds the same,
    with and without remat. The layers' sum would be larger."""
    import dataclasses

    kw = dict(num_layers=5, dtype="float32")
    jcfg = dataclasses.replace(jreduced(jget_config("gemma2-2b"), **kw), num_experts=4,
                               experts_per_token=2)
    cfg = dataclasses.replace(reduced(get_config("gemma2-2b"), **kw), num_experts=4,
                              experts_per_token=2)
    assert [s.ffn for s in cfg.block_specs()] == ["moe"] * 5
    jparams = fill_params(jcfg)
    tokens = _tokens(S, cfg.vocab_size, seed=9)
    _, jaux = _jit_forward(jcfg, "dense")(jparams, jnp.asarray(tokens))
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    with torch.device("meta"):
        model = LM(cfg, generator=None, device="meta")
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, aux = torch.func.functional_call(model, params, (torch.from_numpy(tokens).long(), c))
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    seen, moe_apply = [], L.moe_apply

    def recording(*a, **k):  # each layer's own aux
        out = moe_apply(*a, **k)
        seen.append(out[1])
        return out

    L.moe_apply = recording
    try:
        with torch.no_grad():
            torch.func.functional_call(model, params, (torch.from_numpy(tokens).long(), cfg))
    finally:
        L.moe_apply = moe_apply
    every = [float(a) for a in seen]
    assert len(every) == 5
    np.testing.assert_allclose(float(jaux), every[1] + every[3] + every[4], rtol=1e-5)
    assert sum(every) > float(jaux) + 1.0

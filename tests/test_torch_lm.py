"""The port's Mamba-2 LM against the reference's, on the CPU.

The model is ``reduced(mamba2-370m)`` with 3 layers, so the reference
stacks them into 3 groups of its period-1 slot, and the JAX weights (a
seeded numpy fill of every leaf, so that each layout is exercised) come
across through ``convert.lm_from_jax``.

Tolerances, in f32 (``dtype="float32"``, the point being the algorithm):
logits within atol 1e-4 and rtol 1e-4 and states within 1e-5; XLA and
PyTorch sum the matrix products and einsums in other orders, and three
layers of residual stream carry those last-digit differences. Greedy
tokens are identical. In the config's own bf16 the two frameworks round at
other places (the bf16 products, ``silu``), so each side is about as far
from the other as from the f32 result: forward and prefill logits are held
within twice the reference's own bf16 error (its bf16 logits against its
f32 logits on the same input; that budget is itself under 5 % of the
largest logit), and so is the port's prefill against its own forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.train.checkpoint import _flatten
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve

torch.set_num_threads(2)  # the test workers share the CPU with each other

B, S, GEN = 2, 40, 8  # 40 = one chunk of 32 and a ragged one

VARIANTS = {
    "tied-g1": {},
    "untied-g2": dict(tie_embeddings=False, ssm_ngroups=2),
}


def _cfgs(dtype=None, **tweak):
    jcfg = jreduced(jget_config("mamba2-370m"), num_layers=3)
    cfg = reduced(get_config("mamba2-370m"), num_layers=3)
    if dtype:
        tweak = dict(tweak, dtype=dtype)
    return dataclasses.replace(jcfg, **tweak), dataclasses.replace(cfg, **tweak)


def _reference_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    rng = np.random.default_rng(seed)
    arrays = []
    for path, sds in leaves:
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.normal(size=sds.shape)
        if name in ("in_proj", "out_proj", "unembed"):
            a = n / np.sqrt(sds.shape[-2])
        elif name == "embed":
            a = n * 0.5
        elif name == "A_log":
            a = np.log(np.linspace(1.0, 16.0, sds.shape[-1])) + 0.1 * n
        elif name in ("scale", "D"):
            a = 1.0 + 0.1 * n
        else:  # conv_w, conv_b, dt_bias
            a = 0.1 * n
        arrays.append(jnp.asarray(a, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, arrays)


def _pair(dtype=None, **tweak):
    jcfg, cfg = _cfgs(dtype, **tweak)
    jparams = _reference_params(jcfg)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(convert.lm_from_jax(_flatten(jparams), cfg, device="cpu"))
    return jcfg, cfg, jparams, model.requires_grad_(False)


def _tokens(n, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jit_forward(jcfg, use_ssd_kernel):
    return jax.jit(lambda p, t: jmodels.forward(p, {"tokens": t}, jcfg,
                                                use_ssd_kernel=use_ssd_kernel)[0])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("use_ssd_kernel", [False, True])
def test_forward_matches_reference_f32(variant, use_ssd_kernel):
    jcfg, cfg, jparams, model = _pair("float32", **VARIANTS[variant])
    tokens = _tokens(S, cfg.vocab_size)
    ref = np.asarray(_jit_forward(jcfg, use_ssd_kernel)(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        logits, aux = models.forward(model, {"tokens": tokens}, cfg, use_ssd_kernel=use_ssd_kernel)
    assert logits.shape == (B, S, cfg.vocab_size) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)


def _reference_serve(jcfg, jparams, tokens):
    """The reference's prefill, then GEN greedy decode steps."""
    state = jmodels.init_decode_state(jcfg, B, S + GEN)
    logits, state = jax.jit(lambda p, s, t: jmodels.prefill(p, s, {"tokens": t}, jcfg))(
        jparams, state, jnp.asarray(tokens))
    step = jax.jit(lambda p, s, t: jmodels.decode_step(p, s, t, jcfg))
    first = (np.asarray(logits), jax.tree.map(np.asarray, state))
    toks, step_logits = [], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(GEN):
        toks.append(np.asarray(tok)[:, 0])
        logits, state = step(jparams, state, tok)
        step_logits.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return first, np.stack(toks, 1), step_logits


def _port_serve(model, cfg, tokens):
    with torch.no_grad():
        state = models.init_decode_state(cfg, B, S + GEN, device="cpu")
        logits, state = models.prefill(model, state, {"tokens": tokens}, cfg)
        first = (logits.numpy(), state)
        toks, step_logits = [], []
        tok = logits.argmax(-1)[:, None]
        for _ in range(GEN):
            toks.append(tok[:, 0].numpy())
            logits, state = models.decode_step(model, state, tok, cfg)
            step_logits.append(logits.numpy())
            tok = logits.argmax(-1)[:, None]
    return first, np.stack(toks, 1), step_logits


def test_prefill_and_greedy_decode_match_reference_f32():
    jcfg, cfg, jparams, model = _pair("float32")
    tokens = _tokens(S, cfg.vocab_size, seed=2)
    (jlogits, jstate), jtoks, jsteps = _reference_serve(jcfg, jparams, tokens)
    (logits, state), toks, steps = _port_serve(model, cfg, tokens)
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=1e-4)
    assert state["pos"] == int(jstate["pos"]) == S
    assert len(state["layers"]) == cfg.num_layers
    for layer, st in enumerate(state["layers"]):  # period 1: layer g is group g
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(st[k].numpy(), jstate["layers"][0][k][layer],
                                       atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(toks, jtoks)
    for ours, theirs in zip(steps, jsteps):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


def test_forward_and_prefill_match_reference_bf16():
    jcfg, cfg, jparams, model = _pair()
    assert cfg.dtype == "bfloat16"
    tokens = _tokens(S, cfg.vocab_size, seed=3)
    ref = np.asarray(_jit_forward(jcfg, True)(jparams, jnp.asarray(tokens)))
    jcfg32, _ = _cfgs("float32")
    ref32 = np.asarray(_jit_forward(jcfg32, True)(jparams, jnp.asarray(tokens)))
    budget = 2 * np.abs(ref - ref32).max()  # twice the reference's own bf16 error
    (jlogits, _), _, _ = _reference_serve(jcfg, jparams, tokens)
    with torch.no_grad():
        logits, _ = models.forward(model, {"tokens": tokens}, cfg, use_ssd_kernel=True)
        state = models.init_decode_state(cfg, B, S, device="cpu")
        last, _ = models.prefill(model, state, {"tokens": tokens}, cfg)
    assert 0 < budget < 0.05 * np.abs(ref32).max()
    np.testing.assert_allclose(logits.numpy(), ref, atol=budget, rtol=0)
    np.testing.assert_allclose(last.numpy(), jlogits, atol=budget, rtol=0)
    # the reference's own property: prefill's last logits = forward's last position
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(), atol=budget, rtol=0)


def test_weights_round_trip_exactly():
    for variant in sorted(VARIANTS):
        jcfg, cfg = _cfgs(**VARIANTS[variant])
        flat = _flatten(_reference_params(jcfg, seed=4))
        ported = convert.lm_from_jax(flat, cfg, device="cpu")
        model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert sorted(ported) == sorted(model.state_dict())
        model.load_state_dict(ported)
        for back in (convert.lm_to_jax(ported, cfg), convert.lm_to_jax(model, cfg)):
            assert sorted(back) == sorted(flat)
            for k in flat:
                assert back[k].dtype == flat[k].dtype
                np.testing.assert_array_equal(back[k], flat[k])


def test_unported_families_are_refused():
    cfg = reduced(get_config("mamba2-370m"))
    for family, what in (("encdec", "whisper"), ("vlm", "internvl2")):
        with pytest.raises(NotImplementedError, match=f"item 11.*{what}"):
            models.init_model(dataclasses.replace(cfg, family=family),
                              generator=torch.Generator(), device="cpu")
    # the MoE and hybrid families are ported: they build, leaf for leaf the reference's
    for arch in ("granite-moe-3b-a800m", "zamba2-1.2b"):
        ours = reduced(get_config(arch))
        shapes = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0),
                                                           jreduced(jget_config(arch))))
        model = models.init_model(ours, generator=torch.Generator(), device="cpu")
        assert models.param_count(model) == sum(x.size for x in jax.tree.leaves(shapes))


def test_serve_twin_runs_on_the_cpu(capsys, tmp_path):
    gen = serve.main(["--device", "cpu", "--reduced", "--gen", "4"])
    assert gen.shape == (4, 4)
    out = capsys.readouterr().out
    assert "generated (4, 4)" in out and "request 0:" in out
    # --checkpoint reads a params checkpoint (tests/test_torch_launch_train.py
    # holds it to the reference's files); a missing file raises
    from repro_torch.train import checkpoint as ck

    cfg = reduced(get_config("gemma2-2b"), vocab_size=512)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ck.save(str(tmp_path / "params"), dict(model.named_parameters()), step=2, cfg=cfg)
    again = serve.main(["--device", "cpu", "--reduced", "--gen", "4",
                        "--checkpoint", str(tmp_path / "params")])
    assert "restored checkpoint (step 2)" in capsys.readouterr().out
    assert (again == gen).all()  # the seeded init the checkpoint holds
    with pytest.raises(FileNotFoundError):
        serve.main(["--device", "cpu", "--checkpoint", str(tmp_path / "x.npz")])

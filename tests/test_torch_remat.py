"""The port honours ``ModelConfig.remat`` as the reference does (Queue 3
item 20): a training forward runs each of ``layer_grouping``'s groups
through ``RecomputeGroupFn`` (the reference wraps its scanned group body
in ``jax.checkpoint``), the tail layers plain.

* ``lm_loss``'s gradient with ``remat=True`` against the reference's
  ``jax.grad(lm_loss)`` with ``remat=True``: reduced gemma2-2b (3 layers:
  one group of a local and a global layer, one tail layer), mamba2-370m
  (3 groups of 1) and qwen2.5-3b (2 groups of 1), ``remat`` put back into
  ``reduced()``, at ``test_torch_train_steps.py``'s tolerances.
* Remat against no remat in the port: bit for bit under ``vmap(grad)``
  (the per-peer step's form: the recompute runs the same operations in
  the same order), within 1e-5 of each leaf's largest magnitude under
  ``grad(vmap)`` (the bank-free mean's form: the Function's generated vmap
  rule sums each group's per-peer parameter gradients, where one product
  over the folded peers sums them without remat; 1.0e-6 measured).
* Memory: what the forward saves (autograd's hooks, outside ``torch.func``)
  and the peak of one gradient under ``torch.func`` (a fresh process's
  peak RSS) with remat against without.
* ``Block.forward`` calls: each grouped block twice per gradient (forward
  and recompute), the tail block once; scoring in ``inference_mode``,
  ``no_grad`` and prefill run each block once and give the same logits
  with and without remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.train.checkpoint import _flatten
from repro.train.steps import lm_loss as jlm_loss
from repro_torch import convert, models
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer
from repro_torch.models.transformer import LM, layer_grouping
from repro_torch.train import init_train_state, lm_loss
from repro_torch.optim import adam
from test_torch_train_steps import _batch, fill_params

torch.set_num_threads(2)  # the test workers share the CPU with each other

ARCHS = {  # arch -> (layers, sequence length, groups, period, tail)
    "gemma2-2b": (3, 80, 1, 2, 1),
    "mamba2-370m": (3, 40, 3, 1, 0),
    "qwen2.5-3b": (2, 24, 2, 1, 0),
}
PEERS = 2


def _cfgs(arch, **kw):
    kw = {"num_layers": ARCHS[arch][0], "dtype": "float32", "remat": True, **kw}
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


def _skeleton(cfg):
    with torch.device("meta"):
        return LM(cfg, generator=None, device="meta")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_grouping_is_the_references(arch):
    _, cfg = _cfgs(arch)
    period, n_groups, rem = layer_grouping(cfg)
    assert (n_groups, len(period), rem) == ARCHS[arch][2:]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_gradients_match_reference_remat(arch):
    jcfg, cfg = _cfgs(arch)
    assert jcfg.remat and cfg.remat
    jparams = fill_params(jcfg)
    tokens, labels = _batch(cfg, ARCHS[arch][1])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(lambda p, b: jlm_loss(p, b, jcfg),
                                                    has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = convert.lm_from_jax(_flatten(jparams), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    model = _skeleton(cfg)
    grads, (loss, _) = torch.func.grad_and_value(
        lambda p: lm_loss(model, p, batch, cfg), has_aux=True)(params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = convert.lm_from_jax(_flatten(jgrads), cfg, device="cpu")
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-9, f"{arch} {name}: {err:.3e} beyond 1e-4 x {scale:.3e}"


def _both_forms(cfg, params, batch):
    """(per-peer grads and losses under vmap(grad), the mean loss's grads
    and per-peer losses under grad(vmap))."""
    model = _skeleton(cfg)
    f = lambda p, b: lm_loss(model, p, b, cfg)
    g1, (l1, _) = torch.func.vmap(torch.func.grad_and_value(f, has_aux=True),
                                  in_dims=(None, 0))(params, batch)

    def mean_loss(p, b):
        loss, _ = torch.func.vmap(f, in_dims=(None, 0))(p, b)
        return loss.mean(), loss

    g2, (_, l2) = torch.func.grad_and_value(mean_loss, has_aux=True)(params, batch)
    return (g1, l1), (g2, l2)


def _peer_batch(cfg, seq, seed=2):
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(PEERS, 2, seq + 1)))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_against_no_remat_under_both_step_forms(arch):
    _, cfg = _cfgs(arch)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu")
    batch = _peer_batch(cfg, ARCHS[arch][1])
    (g1, l1), (g2, l2) = _both_forms(cfg, state.params, batch)
    (h1, m1), (h2, m2) = _both_forms(dataclasses.replace(cfg, remat=False), state.params, batch)
    assert torch.equal(l1, m1) and torch.equal(l2, m2)
    for k in h1:
        assert torch.equal(g1[k], h1[k]), f"vmap(grad) {k}"
        scale = float(h2[k].abs().max())
        err = float((g2[k] - h2[k]).abs().max())
        assert err <= 1e-5 * scale, f"grad(vmap) {k}: {err:.3e} beyond 1e-5 x {scale:.3e}"


@pytest.fixture
def block_calls(monkeypatch):
    """Counts ``Block.forward`` calls by layer index."""
    calls = {}
    forward = transformer.Block.forward

    def counting(self, *args, **kw):
        calls[self.layer_index] = calls.get(self.layer_index, 0) + 1
        return forward(self, *args, **kw)

    monkeypatch.setattr(transformer.Block, "forward", counting)
    return calls


def _indexed(model):
    for i, block in enumerate(model.layers):
        block.layer_index = i
    return model


@pytest.mark.parametrize("form", [0, 1])
def test_grouped_blocks_run_twice_and_the_tail_once(block_calls, form):
    """gemma2 with 3 layers: layers 0 and 1 are one group, layer 2 the tail.
    One gradient, under either step form, runs layers 0 and 1 twice
    (forward and recompute) and layer 2 once."""
    _, cfg = _cfgs("gemma2-2b")
    state = init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu")
    batch = _peer_batch(cfg, 24)
    model = _indexed(_skeleton(cfg))
    f = lambda p, b: lm_loss(model, p, b, cfg)
    if form == 0:
        torch.func.vmap(torch.func.grad_and_value(f, has_aux=True), in_dims=(None, 0))(
            state.params, batch)
    else:
        torch.func.grad(lambda p, b: torch.func.vmap(f, in_dims=(None, 0))(p, b)[0].mean())(
            state.params, batch)
    assert block_calls == {0: 2, 1: 2, 2: 1}


def test_remat_keeps_group_inputs_not_activations():
    """What the forward saves for the backward (autograd's saved-tensor
    hooks, outside ``torch.func``), reduced qwen2.5-3b with 4 layers at 2 x
    256 tokens: with remat the groups keep their inputs and parameters, not
    their activations. 22.5 MB saved without remat, 4.5 with (the params
    2.9): less than a quarter."""
    _, cfg = _cfgs("qwen2.5-3b", num_layers=4)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu")
    batch = {k: v[0] for k, v in _peer_batch(cfg, 256).items()}
    saved = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = {k: v.clone().requires_grad_(True) for k, v in state.params.items()}
        seen = {}

        def pack(t):
            seen[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lm_loss(_skeleton(c), params, batch, c)
        saved[remat] = sum(seen.values())
    assert 0 < saved[True] < saved[False] / 4, saved


PEAK = """
import sys, torch
from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import LM
from repro_torch.optim import adam
from repro_torch.train import init_train_state, lm_loss
torch.set_num_threads(2)
remat = sys.argv[1] == "1"
cfg = reduced(get_config("qwen2.5-3b"), num_layers=12, d_ff=512, dtype="float32", remat=remat)
params = dict(init_train_state(torch.Generator().manual_seed(0), cfg, adam(), device="cpu").params)
toks = torch.randint(0, cfg.vocab_size, (2, 2, 1025), generator=torch.Generator().manual_seed(1))
batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
with torch.device("meta"):
    model = LM(cfg, generator=None, device="meta")
f = lambda p, b: lm_loss(model, p, b, cfg)[0]
def hwm():  # this process's peak RSS in kB (the exec'd image's own: getrusage keeps the parent's)
    with open("/proc/self/status") as fh:
        return next(int(line.split()[1]) for line in fh if line.startswith("VmHWM:"))
base = hwm()
torch.func.grad(lambda p, b: torch.func.vmap(f, in_dims=(None, 0))(p, b).mean())(params, batch)
print((hwm() - base) / 1024)
"""


def test_remat_cuts_the_peak_under_torch_func():
    """The peak host memory of one gradient of the peers' mean loss under
    ``torch.func.grad(vmap)`` (the bank-free step's form), reduced
    qwen2.5-3b with 12 layers, 2 peers x 2 x 1024 tokens, each run in a
    fresh process: with remat less than half of without (0.3–0.4
    measured). ``torch.func.grad`` records the backward
    (``create_graph=True``); were the recompute's gradients returned with
    that record, every group's recomputed activations would stay alive and
    the two peaks would be equal."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    peak = {}
    for remat in (1, 0):
        r = subprocess.run([sys.executable, "-c", PEAK, str(remat)], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        peak[remat] = float(r.stdout.split()[-1])
    assert 0 < peak[1] < peak[0] / 2, peak


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "prefill"])
def test_inference_paths_are_unchanged(block_calls, mode):
    _, cfg = _cfgs("gemma2-2b")
    tokens = _peer_batch(cfg, 24)["tokens"][0]
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        model = _indexed(models.init_model(c, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))
        block_calls.clear()
        if mode == "prefill":
            with torch.inference_mode():
                state = models.init_decode_state(c, 2, 30, device="cpu")
                out[remat], _ = models.prefill(model, state, {"tokens": tokens}, c)
        else:
            ctx = torch.inference_mode() if mode == "inference_mode" else torch.no_grad()
            with ctx:
                out[remat], _ = models.forward(model, {"tokens": tokens}, c)
        assert block_calls == {0: 1, 1: 1, 2: 1}
    assert torch.equal(out[True], out[False])


def test_flash_vmap_rules_fold_the_empty_statistics():
    """An f32 forward on CUDA saves no statistics (``_no_stats``: (B, 0)),
    and a remat group's backward runs the flash backward under ``vmap``:
    its rule folds those empty tensors with the peers as it folds q."""
    from types import SimpleNamespace

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf

    q = torch.zeros(PEERS, 3, 5, 2, 4)
    stats = torch.stack([kf._no_stats(q[0])] * PEERS)
    folded = build.fold(SimpleNamespace(batch_size=PEERS), (0, 0, None), (q, stats, stats[0]))
    assert [tuple(t.shape) for t in folded] == [(PEERS * 3, 5, 2, 4), (PEERS * 3, 0),
                                                (PEERS * 3, 0)]

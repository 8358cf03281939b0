"""The port's Zamba2 in its release layout (``configs/zamba2_7b.py``) at a
tiny size on the CPU, in float32: d 64, 2 B/C groups, 2 tied blocks,
hybrid layers [2, 4, 6] of 8 (block A applied twice). The port's loss
and gradients against the benchmark's plain reference
(``p2pbench/reference/zamba2.py``), the reference's logits against
``transformers``' ``Zamba2ForCausalLM`` on the same weights, the grouped
gated norm, one group bit for bit the old path, the tied block's gradient
as the sum of its applications', the shared-block ranges in order, and a
meta-device step at the benchmark cell's size counting its kernel calls."""
import copy
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from p2pbench import harness
from p2pbench.reference import zamba2 as ref
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import p2p
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.train.steps import lm_loss

torch.set_num_threads(2)  # the test workers share the CPU with each other

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "p2pbench" / "configs" / "zamba2-7b.json").read_text())
TINY = dict(num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=32, d_ff=96,
            vocab_size=500, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            hybrid_layer_ids=[2, 4, 6], adapter_rank=8, dtype="float32")
SEED = 2**31 + 29


def tiny_config(**over) -> dict:
    config = copy.deepcopy(CONFIG)
    config["model"].update(TINY, **over)
    return config


def batch(vocab: int, rows: int = 2, seq: int = 48, seed: int = 5):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (rows, seq + 1), generator=g)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def weights(config: dict):
    """The benchmark's seeded weights, the norms, conv biases, dt biases and
    D moved off their constants so that each is read."""
    params = harness.make_params(ref.param_spec(config), SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    for k in params:
        if k.endswith(("scale", "conv_b", "dt_bias", ".D")):
            params[k] = params[k] + 0.1 * torch.randn(params[k].shape, generator=g)
    return params


def test_the_published_config():
    cfg = get_config("zamba2-7b")
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_ngroups, cfg.resolved_head_dim,
            cfg.num_mem_blocks, cfg.adapter_rank, cfg.act) == (81, 3584, 112, 2, 224, 2, 128,
                                                               "gelu_erf")
    assert cfg.param_count() == 7_356_749_648
    cut = ModelConfig(**CONFIG["model"])
    assert cut.hybrid_layer_ids == (6, 11, 17, 23) and cut.param_count() == 2_733_050_240
    assert [i for i, s in enumerate(cut.block_specs()) if s.mixer == "hybrid"] == [6, 11, 17, 23]
    model = models.init_model(cut, generator=None, device="meta")
    assert models.param_count(model) == cut.param_count()
    # the configuration file holds the catalog's numbers, the cut ones listed in reduced
    assert (CONFIG["num_hidden_layers"], CONFIG["hybrid_layer_ids"]) == (24, [6, 11, 17, 23])
    assert CONFIG["reduced"] == ["num_hidden_layers", "layers_block_type", "hybrid_layer_ids"]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(remat):
    config = tiny_config(remat=remat)
    cfg = ModelConfig(**config["model"])
    params = weights(config)
    model = models.init_model(cfg, generator=None, device="meta")
    b = batch(cfg.vocab_size)
    mine = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = lm_loss(model, mine, b, cfg)
    grads = torch.autograd.grad(loss, list(mine.values()))
    theirs = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = ref.loss(theirs, b, config)
    wgrads = torch.autograd.grad(want, list(theirs.values()))
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=2e-6)
    for k, g, w in zip(params, grads, wgrads):
        # f32 on both sides, summed in other orders (the chunked SSD, attend,
        # the shifted-product conv): 1e-4 of the leaf's largest entry
        assert torch.allclose(g, w, rtol=0, atol=1e-4 * float(w.abs().max()) + 1e-9), k
        assert float(w.abs().max()) > 0, k  # every leaf is read


def test_reference_logits_match_transformers():
    pytest.importorskip("transformers")
    from transformers import Zamba2Config, Zamba2ForCausalLM

    config = tiny_config(vocab_size=512)
    m = config["model"]
    params = weights(config)
    hyb, nl = m["hybrid_layer_ids"], m["num_layers"]
    hc = Zamba2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=nl,
        layers_block_type=["hybrid" if i in hyb else "mamba" for i in range(nl)],
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_ngroups=2, n_mamba_heads=8,
        chunk_size=16, intermediate_size=96, hidden_act="gelu", num_attention_heads=4,
        num_key_value_heads=4, num_mem_blocks=2, use_shared_attention_adapter=False,
        adapter_rank=8, use_mem_rope=True, rope_theta=10000, rms_norm_eps=1e-5,
        tie_word_embeddings=True, use_mem_eff_path=False)
    hf = Zamba2ForCausalLM(hc).eval()
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.final_layernorm.weight": params["final_norm.scale"]}
    mamba = [("in_proj.weight", "in_proj.weight"), ("conv1d.weight", "conv_w"),
             ("conv1d.bias", "conv_b"), ("dt_bias", "dt_bias"), ("A_log", "A_log"), ("D", "D"),
             ("norm.weight", "norm.scale"), ("out_proj.weight", "out_proj.weight")]
    for k, i in enumerate(hyb):
        sp, bp, lp = (f"model.layers.{i}.shared_transformer.", f"shared_blocks.{k % 2}.",
                      f"layers.{i}.")
        sd[sp + "input_layernorm.weight"] = params[bp + "ln1.scale"]
        sd[sp + "pre_ff_layernorm.weight"] = params[bp + "ln2.scale"]
        for w in "qkvo":
            sd[sp + f"self_attn.{w}_proj.weight"] = params[bp + f"mixer.w{w}.weight"]
        sd[sp + "feed_forward.gate_up_proj.weight"] = torch.cat(
            [params[bp + "ffn.w_gate.weight"], params[bp + "ffn.w_up.weight"]])
        sd[sp + "feed_forward.down_proj.weight"] = params[bp + "ffn.w_down.weight"]
        adapters = sp + f"feed_forward.gate_up_proj_adapter_list.{k}."
        sd[adapters + "0.weight"] = params[lp + "adapter_in.weight"]
        sd[adapters + "1.weight"] = params[lp + "adapter_out.weight"]
        sd[f"model.layers.{i}.linear.weight"] = params[lp + "linear.weight"]
    for i in range(nl):
        pre = f"model.layers.{i}." + ("mamba_decoder." if i in hyb else "")
        sd[pre + "input_layernorm.weight"] = params[f"layers.{i}.ln1.scale"]
        for a, b in mamba:
            sd[pre + "mamba." + a] = params[f"layers.{i}.mixer." + b]
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    # the head is tied to the embedding; a tied block's adapters are loaded
    # under the one layer's name and read as missing under the other's
    assert not unexpected and {k for k in missing if "adapter_list" not in k} == {"lm_head.weight"}
    assert hf.lm_head.weight.data_ptr() == hf.model.embed_tokens.weight.data_ptr()
    tokens = batch(512, seq=40)["tokens"]
    with torch.no_grad():
        got, want = ref.logits(params, tokens, config), hf(tokens).logits
    # f32 on both sides over 8 layers; the transformers' SSD sums in other orders
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_grouped_norm_normalises_each_group():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 64, generator=g) * torch.linspace(0.1, 4.0, 64)
    scale = torch.rand(64, generator=g) + 0.5
    got = L.rmsnorm_grouped(x, scale, 1e-5, 2)
    halves = [L.rmsnorm(x[..., h * 32:(h + 1) * 32], scale[h * 32:(h + 1) * 32], 1e-5)
              for h in range(2)]
    assert torch.allclose(got, torch.cat(halves, dim=-1), rtol=1e-6, atol=1e-6)
    whole = L.rmsnorm(x, scale, 1e-5)
    assert float((got - whole).abs().max()) > 0.1  # a whole-width norm is another function
    assert torch.equal(L.rmsnorm_grouped(x, scale, 1e-5, 1), whole)


def test_one_group_is_the_old_path_bit_for_bit(monkeypatch):
    """At one B/C group (mamba2-370m's) the mixer's output is what the
    whole-width ``mod.norm`` gave before the grouped norm, bit for bit."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-370m")), dtype="bfloat16")
    mod = S.Mamba2(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        now, _ = S.mamba2_apply(mod, x, cfg)
        monkeypatch.setattr(S, "rmsnorm_grouped", lambda y, scale, eps, groups: mod.norm(y, eps))
        before, _ = S.mamba2_apply(mod, x, cfg)
    assert torch.equal(now, before)


def test_tied_block_gradient_is_the_sum_of_its_applications():
    """Block A is applied at layers 2 and 6: its gradient under remat (the
    port's training forward) is the sum of the gradients of two untied
    copies, one a application, through the plain forward."""
    config = tiny_config(remat=True)
    cfg = ModelConfig(**config["model"])
    params = weights(config)
    model = models.init_model(cfg, generator=None, device="meta")
    b = batch(cfg.vocab_size)
    tied = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = lm_loss(model, tied, b, cfg)
    grads = dict(zip(tied, torch.autograd.grad(loss, list(tied.values()))))

    plain = models.init_model(dataclasses.replace(cfg, remat=False),
                              generator=torch.Generator().manual_seed(0), device="cpu")
    plain.load_state_dict(params, strict=True)
    second = copy.deepcopy(plain.shared_blocks[0])  # block A as layer 6 applies it
    x = plain.embed_tokens(b["tokens"], cfg)
    emb, pos = x, torch.arange(x.shape[1])
    for i, block in enumerate(plain.layers):
        k = cfg.hybrid_layer_ids.index(i) if i in cfg.hybrid_layer_ids else 0
        shared = second if i == 6 else plain.shared_blocks[k % 2]
        x, _, _ = block(x, cfg, positions=pos, shared=shared, emb=emb, application=k)
    x = L.rmsnorm(x, plain.final_norm.scale, cfg.norm_eps)
    logits = plain.unembed_logits(x, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, b["labels"][..., None])[..., 0]
    untied = (lse - gold).mean() + 1e-4 * torch.square(lse).mean()
    untied.backward()
    assert float(untied.detach()) == pytest.approx(float(loss.detach()), rel=1e-6)
    copies = dict(second.named_parameters())
    for name, p in plain.shared_blocks[0].named_parameters():
        want = grads[f"shared_blocks.0.{name}"]
        assert torch.allclose(p.grad + copies[name].grad, want, rtol=0,
                              atol=1e-5 * float(want.abs().max())), name
        assert float(p.grad.abs().max()) > 0 and float(copies[name].grad.abs().max()) > 0


def test_shared_block_ranges_come_in_order(monkeypatch):
    """Each application opens ``SHARED_BLOCK_SPAN`` with (block,
    application): in layer order in the forward, and under remat again in
    the backward's recompute, last layer first; the profiler records them
    as host ranges."""
    seen, span = [], p2p._span

    def recording(name, step=None):
        if name == T.SHARED_BLOCK_SPAN:
            seen.append(step)
        return span(name, step)

    monkeypatch.setattr(p2p, "_span", recording)
    config = tiny_config(remat=True)
    cfg = ModelConfig(**config["model"])
    params = {k: v.requires_grad_() for k, v in weights(config).items()}
    model = models.init_model(cfg, generator=None, device="meta")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = lm_loss(model, params, batch(cfg.vocab_size), cfg)
        loss.backward()
    forward = [(0, 0), (1, 1), (0, 2)]
    assert seen == forward + forward[::-1]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(T.SHARED_BLOCK_SPAN) == 6


def test_a_meta_step_at_the_cells_size_counts_its_kernel_calls():
    """One train step of the benchmark cell (2 peers x 2 x 4,096 tokens, the
    24 layers at published widths) on the meta device: 8 flash forwards (4
    applications and their remat recompute) and 4 backwards, 48 SSD
    forwards and 24 backwards, 48 causal conv forwards and 24 backwards,
    each call charged as it would launch."""
    from repro_torch.launch import dryrun

    count, _, _ = dryrun.meta_train(ModelConfig(**CONFIG["model"]), 2, 2, 4096)
    calls = {k: v[0] for k, v in count.ops.kernels.items()}
    assert calls == {"flash_attention": 8, "flash_attention_backward": 4, "ssd_chunked_grad": 48,
                     "ssd_chunked_grad_backward": 24, "causal_conv_silu": 48,
                     "causal_conv_silu_backward": 24}


def test_the_release_layout_has_no_decode_state():
    cfg = ModelConfig(**tiny_config()["model"])
    with pytest.raises(ValueError, match="no decode state"):
        models.init_decode_state(cfg, 1, 16, device="cpu")

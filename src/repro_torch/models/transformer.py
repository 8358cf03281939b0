"""The LMs of the port, for ``family == "ssm"`` (Mamba-2), ``"dense"``
(gemma2-2b, qwen2.5-3b, starcoder2-3b), ``"hybrid"`` (zamba2-1.2b), ``"moe"``
(granite-moe-3b-a800m, moonshot-v1-16b-a3b, dbrx-132b), ``"vlm"``
(internvl2-26b's stub) and ``"encdec"`` (whisper-base).

A copy of the reference's ``repro/models/transformer.py``. The reference
stacks the layers of each period slot on a leading axis and scans over the
groups (``lax.scan``); here the layers are an ``nn.ModuleList`` run in
order, layer ``g * period + j`` being group g of slot j. ``convert.lm_from_jax``
/ ``lm_to_jax`` carry weights across that layout (``layer_grouping`` gives
it).

zamba2's weight-tied attention + MLP block is ``LM.shared_block``, applied
by every ``shared_attn`` layer at window 0. A ``shared_attn`` layer still
owns an ``ln1``, ``ln2`` and dense ``ffn`` that nothing reads, as the
reference's ``_init_block`` makes them: they keep the params, the
checkpoints and the wire bytes leaf for leaf the reference's, and their
gradients are zero on both sides (ROADMAP.md, reference behaviour 23).

The Zamba2 release's layout (``cfg.hybrid_layer_ids``, the port's own; the
reference has no such config) keeps a Mamba-2 mixer in every layer. With
e the embeddings and h starting at e, a plain layer is h + Mamba(ln1(h));
the k-th hybrid layer first applies ``LM.shared_blocks[k % num_mem_blocks]``
(:class:`MemBlock`) to (h, e), with its own LoRA on the block's MLP, then
its own ``linear``, and adds that to the Mamba input only: h +
Mamba(ln1(h + linear(block(h, e)))). Each application is a host range
``SHARED_BLOCK_SPAN`` with (block, application) as its input. Under remat
each layer is a :class:`RecomputeGroupFn` group of its own, a hybrid
layer's taking e and its block's params as inputs. It trains and scores;
it has no decode state.

The VLM stub is the decoder-only LM with a ``projector`` (d, d): the
stubbed vision encoder's ``patches`` (B, V, d), projected, go before the
token embeddings, and the forward drops their V rows before the head.

Whisper's encoder-decoder is :class:`EncDec`: sinusoidal positions (no
RoPE), an encoder of non-causal self-attention over the stubbed frontend's
frames, and a decoder whose layers add cross attention over the encoder's
output (each layer's K/V computed from it once per call). Its decode state
holds each decoder layer's KV cache and every layer's cross K/V.

With ``cfg.remat`` a training forward (no caches, autograd recording)
runs each group of ``len(period)`` layers through :class:`RecomputeGroupFn`,
as the reference wraps its scanned group body in ``jax.checkpoint``: the
backward keeps each group's input and runs the group again. The tail
layers run plain, as the reference applies them outside its scan. Whisper's
encoder and decoder layers are each a group of one; a decoder group takes
the encoder's output as an input.

The forward returns the MoE layers' summed aux loss as the reference's
scan carries it: each group adds its last layer's aux (every MoE config
has a period of one layer), each tail layer its own.

A decode state holds each layer's SSM state or KV cache in layer order (a
``shared_attn`` layer has its own cache); prefill and decode write the KV
caches in place (``layers.attention_apply``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels import build
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import RMSNorm, dense_linear, rmsnorm, softcap

DecodeState = Dict[str, object]


LM_FAMILIES = ("ssm", "dense", "hybrid", "moe", "vlm")  # the decoder-only LM's
SHARED_BLOCK_SPAN = "repro_torch.model.shared_block"  # one application of a tied block


def require_known_family(cfg: ModelConfig) -> None:
    """Raise for a family that is neither an LM nor the encoder-decoder."""
    if cfg.family not in LM_FAMILIES + ("encdec",):
        raise ValueError(f"unknown model family {cfg.family!r}: the LMs are "
                         f"{', '.join(LM_FAMILIES)} and encdec")


def layer_grouping(cfg: ModelConfig) -> Tuple[Tuple[BlockSpec, ...], int, int]:
    """Return (period_specs, n_groups, n_remainder), as the reference's."""
    specs = cfg.block_specs()
    Lnum = len(specs)
    for p in range(1, Lnum + 1):
        if Lnum % p and (Lnum // p) * p + (Lnum % p) != Lnum:
            continue
        n = Lnum // p
        if n == 0:
            continue
        ok = all(specs[i] == specs[i % p] for i in range(n * p))
        if ok and n >= 1:
            return specs[:p], n, Lnum - n * p
    return specs, 1, 0


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


class RecomputeGroupFn(torch.autograd.Function):
    """``run(positions, x, params) -> (x, aux)``, one group of layers,
    saving only its inputs: the backward runs the group again from the
    saved x and params and takes its vector-Jacobian product
    (``torch.func.vjp``) at the cotangents of both outputs (a MoE group's
    aux has a gradient, through its router), as ``jax.checkpoint`` does.
    Every tensor the group reads is an input, not closed over: inside a
    ``torch.func`` transform a parameter reached by closure gets no
    gradient, and a tensor made at the transform's level cannot be read at
    the Function's. So zamba2's shared block goes in as inputs of every
    group that applies it (its gradient is then the sum over the groups),
    and a ``shared_attn`` layer's unread params get zeros from the vjp.
    ``generate_vmap_rule``: under ``vmap`` the forward and the backward are
    vmapped (the flash Function inside folds the peers into its batch).

    The backward returns its gradients detached: ``torch.func.grad`` takes
    gradients with ``create_graph=True``, so the recompute's backward is
    recorded, and gradients that kept that record would keep every group's
    recomputed activations alive until the transform ends. There is no
    second derivative through a remat group."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, positions, x, *params):
        return run(positions, x, params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *tensors = inputs
        ctx.run = run
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, gy, gaux):
        run, (positions, *primals) = ctx.run, ctx.saved_tensors
        _, vjp = torch.func.vjp(lambda x, *params: run(positions, x, params), *primals)
        return (None, None, *(g.detach() for g in vjp((gy, gaux))))


def _group_runner(blocks, shared, cfg, moe_dispatch: str, use_ssd_kernel: bool):
    """(the group's run function for :class:`RecomputeGroupFn`, its parameter
    tensors in order): each block called through ``functional_call`` with
    its share of the params, then, where a block of the group applies it,
    the shared block's params, called through ``functional_call`` too. The
    group's aux is its last block's, as the reference's scanned body adds."""
    names = [[n for n, _ in b.named_parameters()] for b in blocks]
    uses_shared = any(b.spec.mixer == "shared_attn" for b in blocks)
    shared_names = [n for n, _ in shared.named_parameters()] if uses_shared else []

    def run(positions, x, params):
        it = iter(params)
        block_params = [{n: next(it) for n in ns} for ns in names]
        tied = {n: next(it) for n in shared_names}
        shared_fn = (lambda h, c, **kw: functional_call(shared, tied, (h, c), kw)) if tied else None
        for block, bp in zip(blocks, block_params):
            x, aux, _ = functional_call(block, bp, (x, cfg), {
                "positions": positions, "shared": shared_fn, "moe_dispatch": moe_dispatch,
                "use_ssd_kernel": use_ssd_kernel})
        return x, _zero(x) if aux is None else aux

    params = [p for b in blocks for p in b.parameters()]
    if uses_shared:
        params += list(shared.parameters())
    return run, params


class SharedBlock(nn.Module):
    """zamba2's weight-tied block, the reference's ``shared_block``: ``ln1``,
    attention at window 0, ``ln2`` and the dense MLP."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        pdt = getattr(torch, cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        self.mixer = L.Attention(cfg, generator=generator, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, generator=generator, device=device, dtype=pdt)

    def forward(self, x, cfg, *, positions, cache=None, cache_pos=None):
        h = self.ln1(x, cfg.norm_eps)
        att, new_cache = L.attention_apply(self.mixer, h, cfg, positions=positions, window=0,
                                           cache=cache, cache_pos=cache_pos)
        x = x + att
        return x + L.mlp_apply(self.ffn, self.ln2(x, cfg.norm_eps), cfg.act), new_cache


class MemBlock(nn.Module):
    """One weight-tied block of the Zamba2 release (hf
    ``Zamba2AttentionDecoderLayer``): ``ln1`` over concat(hidden,
    embeddings), 2 d wide; attention projected from those 2 d, causal, at
    the release's scale (head_dim / 2)^-1/2, RoPE over the whole head; ``ln2``
    over the attention's output; the gated MLP with the applying layer's
    LoRA. No residual inside: the layer's ``linear`` takes the MLP's output."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        pdt = getattr(torch, cfg.param_dtype)
        d = cfg.d_model
        self.ln1 = RMSNorm(2 * d, device=device, dtype=pdt)
        self.mixer = L.Attention(cfg, generator=generator, device=device, in_dim=2 * d)
        self.ln2 = RMSNorm(d, device=device, dtype=pdt)
        self.ffn = L.MLP(d, cfg.d_ff, generator=generator, device=device, dtype=pdt)

    def forward(self, x, emb, cfg, *, positions, lora):
        u = self.ln1(torch.cat([x, emb], dim=-1), cfg.norm_eps)
        a, _ = L.attention_apply(self.mixer, u, cfg, positions=positions, window=0,
                                 scale=(cfg.resolved_head_dim / 2) ** -0.5)
        return L.mlp_apply(self.ffn, self.ln2(a, cfg.norm_eps), cfg.act, lora=lora)


class Block(nn.Module):
    """``ln1`` and the mixer (Mamba-2, or attention for ``attn`` and
    ``attn_local``), then, with ``cross`` (whisper's decoder), ``ln_cross``
    and the cross attention, then ``ln2`` and the dense MLP (``ffn ==
    "dense"``) or the MoE layer (``"moe"``). A ``shared_attn`` layer has no
    mixer: it applies the ``shared`` block it is given, and its own ``ln1``,
    ``ln2`` and ``ffn`` are never read (reference behaviour 23). A
    ``hybrid`` layer (the Zamba2 release's) is a Mamba-2 layer that first
    applies the ``shared`` :class:`MemBlock` to (x, ``emb``) with its LoRA
    (``adapter_in``, ``adapter_out``) and adds its ``linear`` of that to the
    Mamba input."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, *, generator: torch.Generator, device,
                 cross: bool = False):
        super().__init__()
        self.spec = spec
        pdt = getattr(torch, cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        if spec.mixer in ("mamba", "hybrid"):
            self.mixer = S.Mamba2(cfg, generator=generator, device=device)
        if spec.mixer == "hybrid":
            lin = lambda din, dout: dense_linear(din, dout, generator=generator, device=device,
                                                 dtype=pdt)
            self.adapter_in = lin(cfg.d_model, cfg.adapter_rank)
            self.adapter_out = lin(cfg.adapter_rank, 2 * cfg.d_ff)
            self.linear = lin(cfg.d_model, cfg.d_model)
        elif spec.mixer in ("attn", "attn_local"):
            self.mixer = L.Attention(cfg, generator=generator, device=device)
        if spec.ffn == "dense":
            self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
            self.ffn = L.MLP(cfg.d_model, cfg.d_ff, generator=generator, device=device, dtype=pdt)
        elif spec.ffn == "moe":
            self.ln2 = RMSNorm(cfg.d_model, device=device, dtype=pdt)
            self.ffn = L.MoE(cfg, generator=generator, device=device)
        if cross:
            self.ln_cross = RMSNorm(cfg.d_model, device=device, dtype=pdt)
            self.cross = L.Attention(cfg, generator=generator, device=device)

    def forward(self, x, cfg, *, positions, cache=None, cache_pos=None, shared=None,
                cross_kv=None, causal=True, moe_dispatch="dense", use_ssd_kernel=False,
                emb=None, application=0):
        """Returns (x, the MoE aux loss or None without MoE (the reference's
        zero: adding it changes no bit), the new cache). ``cross_kv``: the
        encoder's K/V for a block with cross attention; ``causal=False``:
        whisper's encoder. A ``hybrid`` layer takes the embeddings ``emb``
        and its ``application`` (its rank among the hybrid layers), which
        names its range."""
        if self.spec.mixer == "shared_attn":
            x, new_cache = shared(x, cfg, positions=positions, cache=cache, cache_pos=cache_pos)
            return x, None, new_cache
        if self.spec.mixer == "hybrid":
            from repro_torch.core.p2p import _span  # core imports the models

            with _span(SHARED_BLOCK_SPAN, (application % cfg.num_mem_blocks, application)):
                t = shared(x, emb, cfg, positions=positions,
                           lora=(self.adapter_in.weight, self.adapter_out.weight))
            h = self.ln1(x + F.linear(t, self.linear.weight.to(t.dtype)), cfg.norm_eps)
        else:
            h = self.ln1(x, cfg.norm_eps)
        if self.spec.mixer in ("mamba", "hybrid"):
            y, new_cache = S.mamba2_apply(self.mixer, h, cfg, state=cache, use_kernel=use_ssd_kernel)
        else:
            # the reference's window rule (_block_apply)
            if self.spec.mixer == "attn_local":
                window = cfg.sliding_window
            else:
                window = cfg.serve_window if (cache is not None and cfg.sliding_window == 0) else 0
            y, new_cache = L.attention_apply(self.mixer, h, cfg, positions=positions, causal=causal,
                                             window=window, cache=cache, cache_pos=cache_pos)
        x = x + y
        if cross_kv is not None and hasattr(self, "cross"):
            y, _ = L.attention_apply(self.cross, self.ln_cross(x, cfg.norm_eps), cfg,
                                     positions=positions, cache_pos=cache_pos, cross_kv=cross_kv)
            x = x + y
        aux = None
        if self.spec.ffn == "dense":
            x = x + L.mlp_apply(self.ffn, self.ln2(x, cfg.norm_eps), cfg.act)
        elif self.spec.ffn == "moe":
            y, aux = L.moe_apply(self.ffn, self.ln2(x, cfg.norm_eps), cfg, dispatch=moe_dispatch)
            x = x + y
        return x, aux, new_cache


class LM(nn.Module):
    """Embedding, zamba2's ``shared_block`` where a layer applies it, the
    blocks, ``final_norm``, and the tied or untied unembedding."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        require_known_family(cfg)
        pdt = getattr(torch, cfg.param_dtype)
        emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=device)
        self.embed = nn.Parameter((emb * 0.02).to(pdt))
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        if not cfg.tie_embeddings:
            self.unembed = dense_linear(cfg.d_model, cfg.padded_vocab, generator=generator,
                                        device=device, dtype=pdt)
        if any(s.mixer == "shared_attn" for s in cfg.block_specs()):
            self.shared_block = SharedBlock(cfg, generator=generator, device=device)
        if cfg.hybrid_layer_ids:
            self.shared_blocks = nn.ModuleList(MemBlock(cfg, generator=generator, device=device)
                                               for _ in range(cfg.num_mem_blocks))
        if cfg.vision_tokens:
            self.projector = dense_linear(cfg.d_model, cfg.d_model, generator=generator,
                                          device=device, dtype=pdt)
        self.layers = nn.ModuleList(
            Block(cfg, spec, generator=generator, device=device) for spec in cfg.block_specs())

    def embed_tokens(self, tokens: torch.Tensor, cfg: ModelConfig, patches=None) -> torch.Tensor:
        """The token embeddings (gather, then cast: the same values as the
        reference's cast-then-gather), after the VLM's projected ``patches``
        (B, V, d) where the config has vision tokens and they are given."""
        dt = getattr(torch, cfg.dtype)
        x = self.embed[tokens.to(self.embed.device)].to(dt)
        if cfg.vision_tokens and patches is not None:
            pe = F.linear(patches.to(x.device, dt), self.projector.weight.to(dt))
            x = torch.cat([pe, x], dim=1)
        return x

    def unembed_logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        w = self.embed if cfg.tie_embeddings else self.unembed.weight
        logits = F.linear(x, w.to(x.dtype))
        if cfg.padded_vocab != cfg.vocab_size:
            logits = logits[..., : cfg.vocab_size]
        return softcap(logits.to(torch.float32), cfg.final_logit_softcap)

    def forward(self, tokens: torch.Tensor, cfg: ModelConfig, *, patches=None,
                moe_dispatch: str = "dense", use_ssd_kernel: bool = False, head: bool = True):
        """``lm_forward``: what ``torch.func.functional_call`` runs (the
        train step calls the module with the state's params). ``head=False``
        returns the normed hidden state in place of the logits: the train
        step's loss applies the head itself, a chunk of tokens at a time."""
        return lm_forward(self, tokens, cfg, patches=patches, moe_dispatch=moe_dispatch,
                          use_ssd_kernel=use_ssd_kernel, head=head)

    def run(self, x, cfg, *, positions, caches: Optional[List] = None, cache_pos=None,
            moe_dispatch: str = "dense", use_ssd_kernel: bool = False):
        """The stack and ``final_norm``: (x, the summed aux, the new caches)."""
        if cfg.hybrid_layer_ids:  # no decode state: init_decode_state refuses the layout
            return self._run_release(x, cfg, positions=positions, use_ssd_kernel=use_ssd_kernel)
        if cfg.remat and caches is None and torch.is_grad_enabled():
            return self._run_remat(x, cfg, positions=positions, moe_dispatch=moe_dispatch,
                                   use_ssd_kernel=use_ssd_kernel)
        period, n_groups, _ = layer_grouping(cfg)
        grouped, P = n_groups * len(period), len(period)
        aux, new_caches = _zero(x), []
        for i, block in enumerate(self.layers):
            x, a, nc = block(x, cfg, positions=positions,
                             cache=None if caches is None else caches[i], cache_pos=cache_pos,
                             shared=getattr(self, "shared_block", None), moe_dispatch=moe_dispatch,
                             use_ssd_kernel=use_ssd_kernel)
            if a is not None and (i >= grouped or i % P == P - 1):  # a group's last, a tail layer
                aux = aux + a
            new_caches.append(nc)
        return rmsnorm(x, self.final_norm.scale, cfg.norm_eps), aux, new_caches

    def _run_remat(self, x, cfg, *, positions, moe_dispatch: str, use_ssd_kernel: bool):
        """The training forward under ``cfg.remat``: ``layer_grouping``'s
        groups each through one :class:`RecomputeGroupFn`, then the tail
        layers plain."""
        period, n_groups, _ = layer_grouping(cfg)
        P = len(period)
        shared = getattr(self, "shared_block", None)
        if use_ssd_kernel and x.device.type != "cpu" and any(s.mixer == "mamba" for s in period):
            # the groups' forwards run with grad mode off: the SSD kernel's
            # refusal of grad mode (reference behaviour 18) is made here
            build.refuse_grad("ssd_scan", x, *self.layers[0].parameters())
        aux = _zero(x)
        for g in range(n_groups):
            run, params = _group_runner(self.layers[g * P:(g + 1) * P], shared, cfg, moe_dispatch,
                                        use_ssd_kernel)
            x, a = RecomputeGroupFn.apply(run, positions, x, *params)
            aux = aux + a
        for block in self.layers[n_groups * P:]:
            x, a, _ = block(x, cfg, positions=positions, shared=shared, moe_dispatch=moe_dispatch,
                            use_ssd_kernel=use_ssd_kernel)
            if a is not None:
                aux = aux + a
        return rmsnorm(x, self.final_norm.scale, cfg.norm_eps), aux, [None] * len(self.layers)

    def _run_release(self, x, cfg, *, positions, use_ssd_kernel: bool):
        """The Zamba2 release's stack: x is the embeddings e, carried into
        every hybrid layer. Under ``cfg.remat`` in a training forward each
        layer is one :class:`RecomputeGroupFn`, a hybrid layer's with e and
        its block's params among its inputs."""
        emb, k, remat = x, 0, cfg.remat and torch.is_grad_enabled()
        if remat and use_ssd_kernel and x.device.type != "cpu":
            build.refuse_grad("ssd_scan", x, *self.layers[0].parameters())  # as _run_remat
        for i, block in enumerate(self.layers):
            hybrid = block.spec.mixer == "hybrid"
            shared = self.shared_blocks[k % cfg.num_mem_blocks] if hybrid else None
            if remat:
                run, params = _release_runner(block, shared, cfg, k, use_ssd_kernel)
                x, _ = RecomputeGroupFn.apply(run, positions, x, *([emb] if hybrid else []),
                                              *params)
            else:
                x, _, _ = block(x, cfg, positions=positions, shared=shared, emb=emb,
                                application=k, use_ssd_kernel=use_ssd_kernel)
            k += hybrid
        return rmsnorm(x, self.final_norm.scale, cfg.norm_eps), _zero(x), [None] * len(self.layers)


def _release_runner(block, shared, cfg, application: int, use_ssd_kernel: bool):
    """(the run function of one layer of the release layout for
    :class:`RecomputeGroupFn`, its parameter tensors in order: the layer's,
    then its block's where it is hybrid). A hybrid layer's run takes the
    embeddings as its first parameter, so that their gradient flows through
    every application."""
    names = [n for n, _ in block.named_parameters()]
    shared_names = [n for n, _ in shared.named_parameters()] if shared is not None else []

    def run(positions, x, params):
        it = iter(params)
        emb = next(it) if shared is not None else None
        bp = {n: next(it) for n in names}
        tied = {n: next(it) for n in shared_names}
        fn = (lambda h, e, c, **kw: functional_call(shared, tied, (h, e, c), kw)) if tied else None
        x, _, _ = functional_call(block, bp, (x, cfg), {
            "positions": positions, "shared": fn, "emb": emb, "application": application,
            "use_ssd_kernel": use_ssd_kernel})
        return x, _zero(x)

    params = list(block.parameters())
    if shared is not None:
        params += list(shared.parameters())
    return run, params


def lm_forward(
    model: LM, tokens: torch.Tensor, cfg: ModelConfig, *, patches=None,
    moe_dispatch: str = "dense", use_ssd_kernel: bool = False, head: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (scoring). Returns (logits (B, S, vocab) f32, aux),
    or with ``head=False`` (the train step's loss) (the hidden state after
    ``final_norm`` (B, S, d_model) in the compute dtype, aux); aux is the
    MoE layers' summed router loss in f32 (0 without MoE). The VLM's
    ``patches`` (B, V, d) run before the tokens, at positions 0..V-1, and
    their rows are dropped before the head: the result covers the S tokens."""
    x = model.embed_tokens(tokens, cfg, patches)
    x, aux, _ = model.run(x, cfg, positions=torch.arange(x.shape[1], device=x.device),
                          moe_dispatch=moe_dispatch, use_ssd_kernel=use_ssd_kernel)
    x = x[:, x.shape[1] - tokens.shape[1]:]
    return (model.unembed_logits(x, cfg) if head else x), aux


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *, device) -> DecodeState:
    """Each layer's SSM state or KV cache, in layer order. A local
    attention layer's cache holds ``min(seq_len, sliding_window)`` tokens,
    another attention layer's (a ``shared_attn`` layer's too: each keeps its
    own) ``min(seq_len, serve_window)`` when that is set, else ``seq_len``."""
    require_known_family(cfg)
    if cfg.hybrid_layer_ids:
        raise ValueError(f"{cfg.name}: the release layout trains and scores; it has no decode state")
    dt = getattr(torch, cfg.dtype)

    def one(spec: BlockSpec):
        if spec.mixer == "mamba":
            return S.init_mamba2_state(cfg, batch, dt, device=device)
        window = cfg.sliding_window if spec.mixer == "attn_local" else cfg.serve_window
        return L.init_decode_cache(cfg, batch, seq_len, window, dt, device=device)

    return {"pos": 0, "layers": [one(spec) for spec in cfg.block_specs()]}


def lm_prefill(
    model: LM, state: DecodeState, tokens: torch.Tensor, cfg: ModelConfig, *, patches=None,
    moe_dispatch: str = "dense",
) -> Tuple[torch.Tensor, DecodeState]:
    """One-shot prefill of the prompt (B, S), after the VLM's ``patches`` (B,
    V, d) where given, into every layer's state. Returns (last-token logits
    (B, vocab), the state at position V + S). Consumes ``state``: its KV
    caches are written in place and returned."""
    x = model.embed_tokens(tokens, cfg, patches)
    x, _, new_caches = model.run(x, cfg, positions=torch.arange(x.shape[1], device=x.device),
                                 caches=state["layers"], cache_pos=0, moe_dispatch=moe_dispatch)
    logits = model.unembed_logits(x[:, -1:], cfg)[:, 0]
    return logits, {"pos": x.shape[1], "layers": new_caches}


def lm_decode_step(
    model: LM, state: DecodeState, token: torch.Tensor, cfg: ModelConfig, *,
    moe_dispatch: str = "dense",
) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step of token (B, 1): returns (logits (B, vocab), new state).
    Consumes ``state``: its KV caches are written in place and returned."""
    pos = state["pos"]
    x = model.embed_tokens(token, cfg)
    x, _, new_caches = model.run(x, cfg, positions=torch.tensor([pos], device=x.device),
                                 caches=state["layers"], cache_pos=pos, moe_dispatch=moe_dispatch)
    logits = model.unembed_logits(x, cfg)[:, 0]
    return logits, {"pos": pos + 1, "layers": new_caches}


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper)
# ---------------------------------------------------------------------------

_ENCDEC_SPEC = BlockSpec("attn", "dense")


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(S,) positions -> (S, d) f32 [sin | cos], the reference's
    ``_sinusoidal``: frequencies 10000^(-i / max(d/2 - 1, 1))."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10_000.0) * i / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _cross_kv(wk: torch.Tensor, wv: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross K/V from the encoder's output (B, Senc, d)
    and its cross attention's ``wk``, ``wv``: (B, Senc, K, hd) each, in
    ``enc_out``'s dtype."""
    B, Senc, _ = enc_out.shape
    dt = enc_out.dtype
    shape = (B, Senc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (F.linear(enc_out, wk.to(dt)).reshape(shape),
            F.linear(enc_out, wv.to(dt)).reshape(shape))


def _layer_runner(block, cfg, *, encoder: bool):
    """(the run function of one whisper layer for :class:`RecomputeGroupFn`,
    its parameter tensors in order). A decoder layer's run takes the
    encoder's output as its first parameter and computes its cross K/V from
    it, so that the encoder's gradient flows through every decoder layer."""
    names = [n for n, _ in block.named_parameters()]

    def run(positions, x, params):
        if encoder:
            bp, kw = dict(zip(names, params)), {"causal": False}
        else:
            bp = dict(zip(names, params[1:]))
            kw = {"cross_kv": _cross_kv(bp["cross.wk.weight"], bp["cross.wv.weight"], params[0], cfg)}
        x, _, _ = functional_call(block, bp, (x, cfg), dict(kw, positions=positions))
        return x, _zero(x)

    return run, list(block.parameters())


class EncDec(nn.Module):
    """Whisper's encoder-decoder, the reference's ``init_encdec``: ``embed``,
    ``encoder_layers`` blocks of spec ("attn", "dense"), ``num_layers``
    such blocks with cross attention, ``enc_norm``, ``final_norm`` and the
    untied ``unembed``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device):
        super().__init__()
        pdt = getattr(torch, cfg.param_dtype)
        emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator, device=device)
        self.embed = nn.Parameter((emb * 0.02).to(pdt))
        block = lambda cross: Block(cfg, _ENCDEC_SPEC, generator=generator, device=device,
                                    cross=cross)
        self.encoder = nn.ModuleList(block(False) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(block(True) for _ in range(cfg.num_layers))
        self.enc_norm = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        self.final_norm = RMSNorm(cfg.d_model, device=device, dtype=pdt)
        self.unembed = dense_linear(cfg.d_model, cfg.padded_vocab, generator=generator,
                                    device=device, dtype=pdt)

    def forward(self, tokens: torch.Tensor, cfg: ModelConfig, *, frames: torch.Tensor,
                head: bool = True, moe_dispatch: str = "dense", use_ssd_kernel: bool = False):
        """``encdec_forward`` (the train step calls the module through
        ``functional_call``); ``moe_dispatch`` and ``use_ssd_kernel`` are
        ignored, as the reference's ``forward`` ignores them for whisper."""
        return encdec_forward(self, frames, tokens, cfg, head=head)

    def embed_positions(self, tokens: torch.Tensor, cfg: ModelConfig, start: int = 0):
        """(the token embeddings plus the sinusoidal positions from ``start``,
        those positions)."""
        dt = getattr(torch, cfg.dtype)
        x = self.embed[tokens.to(self.embed.device)].to(dt)
        pos = torch.arange(start, start + tokens.shape[1], device=x.device)
        return x + _sinusoidal(pos, cfg.d_model).to(dt), pos

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The head: no softcap, sliced to the vocabulary, f32."""
        return F.linear(x, self.unembed.weight.to(x.dtype))[..., : cfg.vocab_size].to(torch.float32)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode(model: EncDec, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, encoder_seq, d), the stubbed frontend's output -> the
    encoder's output after ``enc_norm``, in the compute dtype."""
    dt = getattr(torch, cfg.dtype)
    frames = frames.to(model.embed.device)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dt) + _sinusoidal(pos, cfg.d_model).to(dt)
    for block in model.encoder:
        if _remat(cfg):
            run, params = _layer_runner(block, cfg, encoder=True)
            x, _ = RecomputeGroupFn.apply(run, pos, x, *params)
        else:
            x, _, _ = block(x, cfg, positions=pos, causal=False)
    return rmsnorm(x, model.enc_norm.scale, cfg.norm_eps)


def encdec_forward(model: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                   *, head: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, vocab) f32, a zero aux), or with ``head=False``
    the decoder's hidden state after ``final_norm`` in place of the logits."""
    enc_out = encode(model, frames, cfg)
    x, pos = model.embed_positions(tokens, cfg)
    for block in model.decoder:
        if _remat(cfg):
            run, params = _layer_runner(block, cfg, encoder=False)
            x, _ = RecomputeGroupFn.apply(run, pos, x, enc_out, *params)
        else:
            ckv = _cross_kv(block.cross.wk.weight, block.cross.wv.weight, enc_out, cfg)
            x, _, _ = block(x, cfg, positions=pos, cross_kv=ckv)
    x = rmsnorm(x, model.final_norm.scale, cfg.norm_eps)
    return (model.logits(x, cfg) if head else x), _zero(x)


def init_encdec_state(cfg: ModelConfig, batch: int, seq_len: int, *, device) -> DecodeState:
    """Each decoder layer's self-attention KV cache (``seq_len`` tokens) and
    every layer's cross K/V, (num_layers, B, encoder_seq, K, hd) each, in
    the compute dtype (``encdec_prefill`` fills them)."""
    dt = getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"pos": 0,
            "self": [L.init_decode_cache(cfg, batch, seq_len, 0, dt, device=device)
                     for _ in range(cfg.num_layers)],
            "cross": {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}}


def encdec_prefill(model: EncDec, state: DecodeState, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """Encode once, write each decoder layer's cross K/V and its KV cache of
    the prompt (B, S), in place. Returns (last-token logits (B, vocab), the
    state at position S)."""
    enc_out = encode(model, frames, cfg)
    x, pos = model.embed_positions(tokens, cfg)
    cross, caches = state["cross"], []
    for i, block in enumerate(model.decoder):
        ck, cv = _cross_kv(block.cross.wk.weight, block.cross.wv.weight, enc_out, cfg)
        cross["k"][i].copy_(ck)
        cross["v"][i].copy_(cv)
        x, _, cache = block(x, cfg, positions=pos, cache=state["self"][i], cache_pos=0,
                            cross_kv=(ck, cv))
        caches.append(cache)
    x = rmsnorm(x[:, -1:], model.final_norm.scale, cfg.norm_eps)
    return model.logits(x, cfg)[:, 0], {"pos": tokens.shape[1], "self": caches, "cross": cross}


def encdec_decode_step(model: EncDec, state: DecodeState, token: torch.Tensor,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step of token (B, 1) over the cached self and cross K/V.
    Returns (logits (B, vocab), the state one position on); the KV caches
    are written in place."""
    p = state["pos"]
    x, pos = model.embed_positions(token, cfg, start=p)
    cross, caches = state["cross"], []
    for i, block in enumerate(model.decoder):
        x, _, cache = block(x, cfg, positions=pos, cache=state["self"][i], cache_pos=p,
                            cross_kv=(cross["k"][i], cross["v"][i]))
        caches.append(cache)
    x = rmsnorm(x, model.final_norm.scale, cfg.norm_eps)
    return model.logits(x, cfg)[:, 0], {"pos": p + 1, "self": caches, "cross": cross}

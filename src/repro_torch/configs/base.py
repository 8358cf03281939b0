"""Model configuration of the port: a copy of the reference's
``repro/configs/base.py`` :class:`ModelConfig`, with the fields of the
port's own release-layout hybrid added at the end of its zamba2 group
(``hybrid_layer_ids``, ``num_mem_blocks``, ``adapter_rank``), each at a
default that leaves every reference config as it was, and the exact
(erf) GELU beside the tanh one in ``act``.

A config fully determines parameter shapes. It is a frozen dataclass, so
configs are hashable. :func:`reduced` and the input shapes
(:class:`ShapeConfig`, ``SHAPES``) are copies of the reference's too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


# ---------------------------------------------------------------------------
# Per-layer block specification
# ---------------------------------------------------------------------------
# mixer:  "attn" | "attn_local" | "mamba" | "shared_attn" (weight-tied, zamba)
#         | "hybrid" (the release layout: a shared block, then a Mamba-2 layer)
# ffn:    "dense" | "moe" | "none"


@dataclass(frozen=True)
class BlockSpec:
    mixer: str = "attn"
    ffn: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``d_ff`` follows the assignment sheet: for MoE archs it is the *expert*
    hidden width (fine-grained experts); for dense archs the MLP width.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | cnn
    source: str  # citation from the assignment sheet

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0  # gemma2 = 50.0
    final_logit_softcap: float = 0.0  # gemma2 = 30.0
    sliding_window: int = 0  # window for "attn_local" mixers
    local_global_pattern: int = 0  # gemma2: every Nth layer is global

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    router_aux_coef: float = 0.01
    moe_shared_ff: int = 0  # width of an always-on shared expert (0 = none)

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0  # insert the shared attention block every N layers
    # the release layout (hf Zyphra/Zamba2-*): every layer is Mamba-2, and
    # the layers listed first apply one of ``num_mem_blocks`` weight-tied
    # attention + MLP blocks (in turn), a rank-``adapter_rank`` LoRA on its
    # MLP's gate and up projections and a linear of their own
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 0
    adapter_rank: int = 0

    # --- encoder/decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0  # frames produced by the (stubbed) conv frontend

    # --- VLM (internvl2) ------------------------------------------------------
    vision_tokens: int = 0  # prefix embeddings from the (stubbed) ViT

    # --- CNN (paper's own models) --------------------------------------------
    cnn_variant: str = ""  # vgg11 | mobilenet_v3_small | squeezenet1_1
    image_size: int = 32
    image_channels: int = 3
    num_classes: int = 10

    # --- numerics / structure -------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # silu (SwiGLU) | gelu (tanh) | gelu_erf (exact)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True

    # --- sharding hints ---------------------------------------------------------
    fsdp: bool = False  # additionally shard params over the data axis (ZeRO-3)
    serve_window: int = 0  # opt-in sliding-window serving for long_500k

    def __post_init__(self):
        # a configuration file gives the list; the frozen config keeps a tuple
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so embedding/unembedding
        tables shard evenly on any production mesh axis (logits are sliced
        back to ``vocab_size``)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def ssm_norm_groups(self) -> int:
        """The groups of channels Mamba-2's gated RMSNorm normalises apart:
        the B/C groups in the release layout, as hf Zamba2 (and mamba_ssm)
        do; one, the whole width, in the reference's layouts, as the
        reference does at any ``ssm_ngroups``."""
        return self.ssm_ngroups if self.hybrid_layer_ids else 1

    def block_specs(self) -> Tuple[BlockSpec, ...]:
        """The per-layer pattern of the decoder stack."""
        if self.family == "cnn":
            return ()
        specs = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                specs.append(BlockSpec("mamba", "none"))
            elif self.family == "hybrid" and self.hybrid_layer_ids:
                # the release layout: Mamba-2 everywhere, the shared block first
                # at the hybrid layers
                specs.append(BlockSpec("hybrid" if i in self.hybrid_layer_ids else "mamba",
                                       "none"))
            elif self.family == "hybrid":
                # zamba2: mamba backbone; a weight-tied attention+MLP block is
                # applied every `shared_attn_every` layers.
                if self.shared_attn_every and (i + 1) % self.shared_attn_every == 0:
                    specs.append(BlockSpec("shared_attn", "dense"))
                else:
                    specs.append(BlockSpec("mamba", "none"))
            else:
                if self.local_global_pattern:
                    # gemma2: alternating local / global attention
                    mixer = (
                        "attn"
                        if (i % self.local_global_pattern)
                        == self.local_global_pattern - 1
                        else "attn_local"
                    )
                else:
                    mixer = "attn"
                ffn = "moe" if self.num_experts else "dense"
                specs.append(BlockSpec(mixer, ffn))
        return tuple(specs)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head). The release
        layout's is the module's own, the final norm and each layer's one
        norm included."""
        if self.family == "cnn":
            return -1  # computed from the pytree instead
        if self.hybrid_layer_ids:
            return self._release_param_count()
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (
            self.num_heads * hd
        ) * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        if self.moe_shared_ff:
            moe_ffn += 3 * d * self.moe_shared_ff
        mamba = 0
        if self.ssm_state:
            di, H, N, G = self.d_inner, self.ssm_heads, self.ssm_state, self.ssm_ngroups
            in_proj = d * (2 * di + 2 * G * N + H)
            mamba = in_proj + self.ssm_conv * (di + 2 * G * N) + di * d + 2 * H + di
        shared = attn + dense_ffn  # counted once if weight-tied
        tied_done = False
        for spec in self.block_specs():
            n += 2 * d  # norms
            if spec.mixer in ("attn", "attn_local"):
                n += attn
            elif spec.mixer == "mamba":
                n += mamba
            elif spec.mixer == "shared_attn":
                if not tied_done:
                    n += shared
                    tied_done = True
                continue  # ffn included in the tied block
            if spec.ffn == "dense":
                n += dense_ffn
            elif spec.ffn == "moe":
                n += moe_ffn
        if self.encoder_layers:
            n += self.encoder_layers * (2 * d + attn + dense_ffn)
            n += self.num_layers * (d + attn)  # decoder cross-attention
        return n

    def shared_block_param_count(self) -> int:
        """One weight-tied block of the release layout: the norm over
        concat(hidden, embeddings), attention from 2 d, the MLP's norm and
        its gated MLP."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = 2 * d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        return 2 * d + attn + d + 3 * d * self.d_ff

    def _release_param_count(self) -> int:
        """The embedding (or two tables) and the final norm; each layer's norm
        and Mamba-2 mixer (in_proj, the biased depthwise conv, A_log, D,
        dt_bias, the gated norm, out_proj); the tied blocks once; each
        application's LoRA (d -> rank -> 2 d_ff) and linear (d, d)."""
        d, di, H, N, G = self.d_model, self.d_inner, self.ssm_heads, self.ssm_state, self.ssm_ngroups
        mamba = (d * (2 * di + 2 * G * N + H) + (self.ssm_conv + 1) * (di + 2 * G * N) + 3 * H + di
                 + di * d)
        application = self.adapter_rank * (d + 2 * self.d_ff) + d * d
        return (self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
                + self.num_layers * (d + mamba) + self.num_mem_blocks * self.shared_block_param_count()
                + len(self.hybrid_layer_ids) * application)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        per_expert = 3 * d * self.d_ff
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        return full - self.num_layers * inactive


# ---------------------------------------------------------------------------
# Input shapes (the 4 assigned shapes)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (<=2 layers, d<=512)."""
    small = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128) or 128,
        num_heads=min(cfg.num_heads, 4) or 4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32 if cfg.num_heads else 0,
    )
    if cfg.num_experts:
        small.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.shared_attn_every:
        small.update(shared_attn_every=2)
    if cfg.local_global_pattern:
        small.update(local_global_pattern=2, sliding_window=64)
    if cfg.sliding_window and not cfg.local_global_pattern:
        small.update(sliding_window=64)
    if cfg.encoder_layers:
        small.update(encoder_layers=2, encoder_seq=64)
    if cfg.vision_tokens:
        small.update(vision_tokens=16)
    if cfg.moe_shared_ff:
        small.update(moe_shared_ff=64)
    small.update(name=cfg.name + "-smoke", remat=False, fsdp=False)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

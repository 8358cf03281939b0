#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, no arguments
    python3 chip_smoke.py --select-timing SRC   # the select alone (below)
    python3 chip_smoke.py --scatter-timing SRC  # the scatter alone (below)
    python3 chip_smoke.py --ssd-timing SRC      # the SSD scan alone (below)
    python3 chip_smoke.py --p2p-timing SRC      # the P2P paths holding params once (below)
    python3 chip_smoke.py --zamba2-kernels      # the zamba2-7b cell's kernel shapes (below)

Phases, each of which fails the run on a failed check (none catches its own
failure):

1. build   — compile every CUDA source of the port with nvcc (into build/),
             one nvcc per source, all started together.
2. kernels — each kernel against its plain PyTorch version on the card: the
             QSGD kernels at VGG-11's largest leaf (8192 x 2048 buckets),
             ragged shapes and all-zero buckets; dequantize-and-reduce at
             (4, 8192, 2048) and ragged shapes; the top-k select, values
             and indices identical to the plain version, at fc2/w
             (16,777,216 elements, k = 1 %), n = 301 with k = 3, exact ties,
             a leaf of mostly exact zeros, an all-zero leaf, k = n, n = 1,
             a NaN leaf, denormal magnitudes, +inf (n = 2, k = 1, and more
             +inf entries than k), equal magnitudes, rows at the one-block
             body's threshold - 1, at it and + 1, and (4, n) banks (one
             launch each, every row identical) at mobilenet-v3-small's 46
             distinct leaf sizes and at fc2/w; the scatter, every row bit
             for bit (NaN at the same positions), at P = 4 with shared
             indices (both bodies), as (1 mix + 4 own rows) banks in one
             launch each at the 46 leaf sizes and at fc2/w (both bodies),
             at the tile body's limit - 1, at it and + 1, with ring mixing
             at P = 1, 3 and 4, and on special payloads (-0.0, +inf, NaN,
             a NaN leaf's payload, indices below 0 and past n); the SSD
             scan at the
             mamba2-370m scoring shape (4, 2048, 32, 64), G = 1, N = 128,
             chunk 256, in bf16 (the tensor-core body) and f32 (the
             CUDA-core body), at a padded last chunk with 4 groups, and at a
             single chunk, in both types; in bf16 also at one 32k sequence
             and at chunk 16 with N = 8; at zamba2-1.2b's scoring shape (4,
             2048, 64 heads of 64), N = 64, chunk 256, in both types;
             flash attention at gemma2-2b's
             scoring shape (1, 8192, 8 heads over 4, D 256), softcap 50,
             window 4096 and none, in bf16 (the tensor-core body), the same
             at S = 1024 in f32 (the CUDA-core body), and in both types a
             ragged S = 1000, Sq 300 against Skv 500 without causal
             masking, D 32, 64 and 128, MHA (32 heads, D 64), and at 2 x
             2048 granite-moe's GQA groups of 3 (24 heads over 8, D 64) and
             zamba2's MHA (32 heads, D 64); in bf16
             also Sq 200 with a window of 40, D 96, 160, 192 and 224, and q,
             k, v as strided views of one fused projection. The flash
             backward kernel against autograd of the plain version in f32,
             in f32 (the CUDA-core body) and bf16 (the tensor-core body):
             gemma2-2b's heads at S = 8192 with softcap 50, global and
             windowed (4096), where planted faults (a dropped softcap
             derivative, an ignored window, a skipped key tile) must fall
             outside the limit, and at a ragged S = 1000 with a window of
             300; qwen2.5-3b's heads (16 over 2, D 128) at a ragged S =
             1000; Sq 300 against Skv 500 without causal masking; D 32 and
             64; granite-moe's and zamba2's heads at 2 x 2048; in bf16 also
             D 96, 160, 192 and 224. In bf16 a second call
             must give the same bits, and the forward's saved lse and o in
             f32 must match the plain twin; ptxas's registers and spills of
             every backward instance are printed at the build, and the
             tensor-core instances must spill nothing. With an input
             requiring grad the flash wrapper launches its forward and
             backward kernels once each; the SSD wrapper, which has no
             backward (reference behaviour 18), refuses grad mode with no
             launch, and launches under ``torch.inference_mode()``. The
             SSD's training route (``ssd_chunked_grad`` and its backward)
             at mamba2-370m's train cell, 2 peers x 16 x 2048 folded, on
             the model's strided views: y within 2e-5 of max|y| and dx,
             ddt, dA, dB and dC within 5e-5 of each one's largest
             magnitude (plus bf16 rounding where written in bf16) of
             autograd of ``ssd_chunked``, a second backward the same bits;
             both timed beside their plain versions. The same at the
             zamba2-7b cell's (4, 4096, 112 heads of 64, 2 groups), N 64;
             and the flash kernels at its (4, 4096, 32 heads of 224),
             causal, at the release's scale (224 / 2)^-1/2: the forward and
             the backward within their limits of the plain versions at that
             scale, the default scale's outside them, each timed beside its
             plain version (the kernels line's ``zamba2_7b`` entries). The
             causal conv's kernels (``causal_conv_silu`` and its backward)
             at both cells' shapes on the projection's strided view: y, dx,
             dw and db within 1e-5 of each one's largest magnitude plus
             their bf16 rounding of autograd of the plain conv and SiLU in
             f32, a second call the same bits; each timed beside the plain
             bf16 version and its autograd.
3. reference — small runs on the card against the same runs on the CPU
             (plain versions), same init and uniforms: a 4-peer squeezenet
             QSGD cluster epoch, one device train step with qsgd + EF and
             with topk + EF, the reference's churned async cluster scenario
             (2 squeezenet peers, churn 0.3, ``sim_compute_s`` pinned, 2
             epochs: equal trace digests, params within 1e-5), 2 epochs
             of 4 squeezenet peers with ``trimmed_mean:0.25`` and a
             sign_flip attacker and with ``reduce_scatter`` (params within
             1e-5, 1e-4 where the trim keeps the attacker's row), a 3-layer
             reduced mamba2, a 3-layer reduced gemma2 (S 160 over its
             window of 64), a 3-layer reduced zamba2 (SSD kernel, the shared
             block's flash), a 3-layer reduced granite-moe (dense and
             capacity dispatch), a reduced whisper-base (2 encoder and 3
             decoder layers, 64 frames a row) and a 3-layer reduced
             internvl2-26b (16 patches a row) in f32 (forward, prefill
             logits and states or caches, whisper's cross K/V too, 8 greedy
             decode steps); per-peer bank steps of
             squeezenet (``allgather_mean`` and ``async`` K = 2 on the ring
             over 3 steps, ``qsgd(7, 256)`` + EF on the ring for 1), each
             card step from the CPU's state, bounded by the two sides'
             gradient gap at those params; a determinism phase under
             PyTorch's default global flags (two seeded mobilenet QSGD
             clusters bit-identical, a vgg11 gradient bit-identical with
             global TF32 on and off, the CNN paths under
             ``torch.use_deterministic_algorithms(True)``). The script
             sets none of PyTorch's global flags: the port runs its CNNs
             in ``models.cnn.f32_numerics``. One train step of a 3-layer
             reduced gemma2-2b in f32 (2 peers, S 160 over its window of
             64) from one state on the card (flash kernels forward and
             backward) and on the CPU: plain SGD at rate 1, each leaf's
             update within 1e-4 of its largest magnitude, and likewise of a
             3-layer reduced mamba2, zamba2 (its shared_attn layer's unread
             params unmoved on both sides), granite-moe with each
             dispatch, whisper-base (remat on, with frames) and
             internvl2-26b (with patches); the gemma2 and the zamba2 step on the card with
             ``remat`` on and off: the same loss, the updates within the
             same limit, 5 and 3 (zamba2: 2 and 1) flash forwards; they run just
             before the train paths, because ``build_train_step``
             switches the allocator to expandable segments and every
             earlier phase keeps PyTorch's default ones.
4. path    — the main paths. ``LocalP2PCluster(...).run`` with the QSGD
             exchange: mobilenet-v3-small (full graph, 3 epochs), vgg11
             (full graph, 2 epochs), mobilenet-v3-small (ring, EF, 1 epoch);
             with the top-k exchange: mobilenet-v3-small (full graph, EF,
             1 epoch). ``build_p2p_train_step`` at full width: vgg11 with
             qsgd(127, 2048) + EF and mobilenet-v3-small with topk(0.01) +
             EF, 4 peers x batch 32 on CIFAR-shaped 32x32 data, 4 steps
             each (one bank select of all 4 peers per leaf and step, and
             one bank scatter into the mix and the 4 own images).
             The accounting runs: mobilenet-v3-small with qsgd(127, 2048)
             through a ``ServerlessExecutor`` (AWS-default runtime,
             latency-driven memory), 16 batches per peer and epoch, 2
             epochs: every batch timed with the card synchronised, each
             report's simulated Lambda wall and dollars printed beside the
             same batch times priced on a t2.large (simulated accounting,
             not a measurement of Lambda); an async mobilenet-v3-small
             cluster with topk(0.01) + EF, peer speeds 1 / 1.25 / 1.5 / 2,
             churn 0.2, 2 epochs, a trace recorder attached (scatter
             launches = the trace's consumes + publishes, per leaf; no
             trace error).
             The robust, sharded and tree runs, 2 epochs each:
             mobilenet-v3-small with ``trimmed_mean:0.25`` and a sign_flip
             attacker, with ``median`` on the ring, a scaled_noise attacker
             and ``reject_nonfinite``; vgg11 with ``krum`` and a
             scaled_noise attacker (Krum over the last epoch's published
             bank must not pick the attacker); vgg11 ``reduce_scatter`` and
             mobilenet-v3-small ``tree:2`` through the priced executor (one
             wave of 4 aggregators, or one per hub level, an epoch, each
             printed; reduce_scatter's aggregators sized from shard bytes;
             params within 1e-6 of an ``allgather_mean`` run); the
             mobilenet QSGD cluster with a stale_replay attacker (one
             poisoned publish; its QSGD launches count in the kernels
             line). Device steps of vgg11, 4 each: ``reduce_scatter`` and
             ``tree`` (step 1 within 1e-6 of an ``allgather_mean`` step),
             ``trimmed_mean:0.25`` with a sign_flip attacker (profiled:
             the device's idle share) and ``krum`` with a scaled_noise
             attacker; these launch none of the kernels. Per-peer bank
             steps (``peer_bank``), 4 each: vgg11 qsgd(127, 2048) + EF on
             the ring (one ``dequant_reduce`` per peer's mix and leaf),
             mobilenet-v3-small topk(0.01) + EF on ``hierarchical:2``,
             vgg11 ``async`` with staleness 2, vgg11 ``trimmed_mean:0.34``
             with a sign_flip attacker on the ring; each prints the
             largest gap between bank rows, which must be above 0.
             mamba2-370m at full width (48 layers, bf16): the scoring
             ``forward(..., use_ssd_kernel=True)`` on 4 x 2048 tokens (48
             SSD launches each) and the serve twin's prefill of 4 x 512
             and 32 greedy tokens (no SSD launch, as in the reference).
             gemma2-2b at full width (26 layers, bf16): the scoring
             ``forward`` on 1 x 8192 tokens (26 flash launches each), the serve twin at batch 4 with a
             512-token prompt and 32 greedy tokens, and at batch 1 with a
             6144-token prompt (the local layers' 4096-token caches roll)
             and 16 tokens (26 flash launches in each prefill, none in
             decode). zamba2-1.2b at full width (38 layers: 32 Mamba-2, 6
             applying the one weight-tied attention + MLP block; bf16):
             scoring ``forward(..., use_ssd_kernel=True)`` on 4 x 2048 (32
             SSD and 6 flash launches each) and the serve twin at batch 4 x
             512 + 32 tokens (6 flash launches in prefill, none in decode).
             granite-moe-3b-a800m at full width (32 layers, 40 experts, top
             8): scoring on 4 x 2048 with the dense and with the capacity
             dispatch (32 flash launches each) and the serve twin as
             zamba2's (32 flash launches in prefill). whisper-base at full
             width and depth (6 encoder and 6 decoder layers, seeded
             frames of (16, 1500, 512)): scoring on 16 x (1500 frames, 448
             tokens), 18 flash launches each (6 encoder non-causal, 6
             decoder causal, 6 cross, 448 queries over 1500 keys), and
             serving 16 x 4 prompt tokens with their frames and 64 greedy
             tokens (18 in prefill, 0 in decode). After the profile phase,
             moonshot-v1-16b-a3b at its published widths with its depth
             CUT to the layers that fit (``depth_that_fits``: 27 of 48 on
             an 80 GB card, printed): scoring on 1 x 2048 (a flash launch
             a layer); internvl2-26b likewise (40 of 48, 48 heads of 128
             over 8, seeded patches of (1, 256, 6144)): scoring on 1 x (256
             + 2048) and serving 1 x (256 + 512) and 16 tokens (a flash
             launch a layer in each forward and prefill). Launch counters are zeroed before and read after each
             run and must equal the counts the path implies. Then the SSD
             kernel is held to its plain version on one layer's own inputs
             from a scoring forward, and the flash kernel on a global and
             a local layer's (and on the new paths' first attention layer,
             and the SSD kernel on zamba2's layer 0); those forwards'
             launches, and those of the prefill-vs-forward checks, stay out
             of the kernels line.
             LM training (run after the profile phase, once the serving
             models are freed), every config with ``remat`` on as
             published (each layer group run again in the backward):
             gemma2-2b at full width through ``train.build_train_step``
             (``allgather_mean``, Adam at 3e-3 under ``warmup_cosine``), 2
             peers x batch 1 x 2048 tokens, 4 steps on one fixed batch, the
             bytes reckoned first, no cut (running out of memory fails):
             52 flash forward (each layer's and its recompute's) and 26
             backward launches a step, the peers folded into the batch, a
             finite loss that falls, the peak memory printed; the backward
             kernel then held to the plain backward on a local and a global
             layer's own inputs and saved statistics from one more step
             (kept out of the kernels line), its profile showing the
             forward's 52 and the backward's two tensor-core launches a
             layer; two mamba2-370m steps at 2 x 2048 through
             ``ssd_chunked_grad`` (96 forward and 48 backward launches a
             step), and the same step with
             ``use_ssd_kernel=True`` refused before any launch. The train
             CLI twin (``repro_torch.launch.train.main``, through
             ``P2PTrainer``): qwen2.5-3b at full width, ``--data-parallel 2
             --batch 2 --seq 2048 --steps 4 --backend instance
             --serverless-report`` (72 flash forwards and 36 backwards a
             step, finite losses, every leaf moved, s/step and peak memory
             printed, the backward kernel held to the plain backward on its
             last layer's inputs; its 13.6 GB of params exceed a Lambda, so
             the serverless and frontier lines come from the next run);
             reduced qwen2.5-3b with ``remat`` put back, ``--exchange qsgd
             --ef --cost-report --serverless-report`` (the QSGD kernels), 3 steps
             written with ``--checkpoint``, one step ``--restore``d from the
             file the same bits as the same step from the state held in
             memory, and the serve twin's ``--checkpoint`` reading the
             file; the example twin (qwen-100m, qsgd, 2 peers) for 3 steps.
             Then zamba2-1.2b (its Mamba-2 layers through
             ``ssd_chunked_grad``: 62 forwards and 32 backwards a step) and
             granite-moe-3b-a800m (dense dispatch) through
             ``train.build_train_step`` as gemma2-2b: 2 peers x 2048, 4 Adam
             steps, remat on, no cut; 12 flash forwards and 6 backwards a
             step (zamba2), 64 and 32 (granite); every leaf moved but
             zamba2's unread slot params, which stay bit for bit as
             initialised (reference behaviour 23); the backward kernel held
             to the plain backward on the last step's last attention layer.
             granite trains at Adam 3e-4, a cut: at the CLI's 3e-3 its
             loss rises, and ``granite_cli_rate`` runs those steps with
             flash's kernels and with its plain version, which must agree.
             whisper-base trained likewise at 2 peers x 8 x (1500 frames,
             448 tokens), Adam 3e-3, remat on: 36 flash forwards and 18
             backwards a step; the backward kernel held to the plain
             backward on the last step's last encoder layer, last cross
             attention and last decoder self-attention, with dq held to
             the backward in f64 (their cotangents are tiny and dq
             cancels; both rules printed, a skipped key tile must fail
             each gradient and bf16 products dq), and timed on the first
             two beside SDPA's backward. The serve_decode example twin
             (gemma2-2b, mamba2-370m, zamba2-1.2b reduced, 4 x 48 greedy
             tokens, no launch).
5. timing  — each kernel, its plain version, the PyTorch call that computes
             the same function where there is one, and the bound, at the
             main path's largest shapes, timed with CUDA events; the select
             also at (4, n) banks, over one mobilenet device step's 180
             bank selects, and both its bodies over a sweep of row lengths;
             the scatter beside ``index_add_`` at fc2/w, at the device
             step's (1 mix + 4 own rows) banks, over one step's 180 bank
             scatters, and both its bodies over a sweep of row lengths;
             the flash forward also writing what the backward reads; the
             flash backward kernel at gemma2-2b's scoring shape and on the
             train path's inputs beside its bound, the plain backward and
             the backward of ``flex_attention`` under ``torch.compile``;
             the SSD scan also at one 32k sequence,
             beside the bf16 bound
             and the fp32-rate bound of earlier rows; the robust
             estimators (trimmed mean, median, Krum's Gram matrix and
             selection) and the ``reduce_scatter`` and ``tree:2`` combines
             on a (4, vgg11's 28.1 M) f32 bank beside their byte bounds;
             the SSD scan and the flash forward at the zamba2, granite and
             moonshot scoring shapes and the flash backward at granite's
             train shape, beside their plain versions, bounds and SDPA
             (printed only); the flash forward at whisper-base's encoder
             (16, 1500, 8, 64) and cross (448 over 1500) shapes,
             non-causal, and its decoder's, beside SDPA with the same mask
             (printed only); the per-peer gradients of vgg11 and mobilenet at 4 x 32,
             banked (vmap over the bank), looped over the peers and held
             once, with deterministic cuDNN and with non-deterministic
             algorithms allowed.
6. profile — ``torch.profiler`` over one scoring forward and 4 decode
             steps of mamba2-370m and of gemma2-2b: the device's busy and
             idle share and kernel time by kind (SSD or flash kernel,
             matrix products, the rest), and the flash and SSD launches by
             body: a gemma2-2b forward must launch flash's bf16 body once
             per layer and its f32 body never, a mamba2-370m forward each
             of the SSD bf16 body's three passes once per layer and its f32
             body never; a zamba2-1.2b forward each SSD pass 32 times and
             flash's bf16 body at D 64 6 times. Each profile runs its work twice and reads the
             second run only (the profiler can lose the device records of
             a session's first launches); a profile that still lost the
             device record of a launch it recorded on the host is taken
             again, at most three times in all; the last one is held to the
             rule.
7. dryrun  — the H100 dry run (``repro_torch.launch.dryrun``) held to the
             card on five paths the script runs anyway: the train steps
             of gemma2-2b and zamba2-1.2b (2 peers x 2048, remat; zamba2's
             weight-tied shared block in every group) and whisper-base's
             (2 x 8 x (1500, 448)), each one more step after the path's
             checks, and
             mamba2-370m's and zamba2-1.2b's scoring forwards (4 x 2048,
             the SSD kernel; zamba2's flash kernel too), one more forward
             after their timed ones. Each runs on the card under
             ``launch.op_analysis.OpCount`` and on the meta device from the
             same shapes: FLOPs and op bytes equal, each kernel charged as
             many times, the meta peak within 5 % of
             ``max_memory_allocated`` (after ``reset_peak_memory_stats``,
             less what is held beside the run's arguments). Printed: the
             reckoned time (the larger of the compute and memory terms at
             989.4 TFLOP/s and 3.35 TB/s) beside the measured s/step or
             s/forward, the model-FLOPs share of 989.4 TFLOP/s with the
             card's name and power limit, and the card's memory against
             ``launch.mesh.HBM_BYTES``. These runs' launches stay out of
             the kernels line. The two train paths print the meta count's
             peak and FLOPs before their first step. The kernels' bounds in the timing phase come from the cost
             functions that the kernels charge and the dry run counts
             (``repro_torch/kernels/cost.py``), this checkout's in every
             mode, so the ``SRC`` modes below time an earlier checkout's
             kernels against the same bounds.

The last two lines of stdout are a ``{"kernels": [...]}`` JSON line and the
result ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.

``--zamba2-kernels`` runs only the zamba2-7b cell's kernel checks and
timings (the SSD's training route, the flash kernels and the causal conv's
kernels at its shapes) and prints their rows as one JSON line, no result
line.

``--ssd-timing SRC`` runs only the SSD kernel's timing, likewise with the
``repro_torch`` under SRC; it prints no result line.

``--p2p-timing SRC`` runs only the P2P paths that hold params once
(clusters and device steps, their checks left out), with the
``repro_torch`` under SRC and cuDNN TF32 off globally, as the script set
it before the port chose its own CNN numerics: run it for an earlier
checkout and this one in one call. It prints no result line.

``--train-timing SRC`` runs only the train paths' steps (mamba2-370m at 2
x 1024, gemma2-2b down its cuts and at 2 x 512, launch counts unchecked)
with the ``repro_torch``
under SRC, on fixed allocator segments unless ``PYTORCH_CUDA_ALLOC_CONF``
asks for expandable ones: run it for an earlier checkout and this one, in
both modes, in one call. It prints no result line.

``--scatter-timing SRC`` runs only the scatter's timing and the mobilenet
top-k + EF device step (with a profile of one step) on the ``repro_torch``
under SRC, making two scatter launches a leaf where that has no bank
scatter (as its device step did); it prints no result line.

``--select-timing SRC`` runs only the select's timing and the mobilenet
top-k + EF device step (with a profile of one step) on the ``repro_torch``
under SRC, such as an earlier commit's ``src`` unpacked with ``git
archive``, launching once per row where that has no bank select: run it
for both commits in one call to compare them on one card. It prints no
result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _load_by_path(name: str, *parts: str):
    """A module of this checkout's ``repro_torch`` that imports nothing of
    the package, loaded by its path: the timing modes import another
    checkout's ``repro_torch``, and time it against this one's yardsticks."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT.joinpath("src", "repro_torch", *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the H100 SXM's data sheet (HBM bandwidth, fp32 and dense bf16 rates,
# memory) and every kernel's cost function, which the bounds reckon from
CARD = _load_by_path("_card_mesh", "launch", "mesh.py")
COST = _load_by_path("_kernel_cost", "kernels", "cost.py")
HBM_BYTES_PER_S = CARD.HBM_BW
FP32_FLOPS = CARD.PEAK_FLOPS_FP32
BF16_FLOPS = CARD.PEAK_FLOPS_BF16
S = 127  # QSGD levels on the main path
BUCKET = 2048  # QSGD bucket on the main path
FC2 = 4096 * 4096  # vgg11 fc2/w, the largest leaf
FC2_ROWS = FC2 // BUCKET  # 8192 buckets
PEERS = 4
TOPK_FRAC = 0.01  # top-k fraction on the main path
FC2_K = round(FC2 * TOPK_FRAC)  # 167,772
KERNELS = {  # name -> (module attribute, CUDA source, TPU kernel it replaces)
    "qsgd_quantize": ("kq", "qsgd.cu", "src/repro/kernels/qsgd.py:22"),
    "qsgd_dequantize": ("kq", "qsgd.cu", "src/repro/kernels/qsgd.py:36"),
    "qsgd_dequant_reduce": ("kq", "qsgd.cu", "src/repro/kernels/qsgd.py:42"),
    "topk_select_pack": ("kt", "topk.cu", "src/repro/kernels/topk.py:45"),
    "topk_scatter_accum": ("kt", "topk.cu", "src/repro/kernels/topk.py:122"),
    "ssd_scan": ("ks", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:31"),
    "flash_attention": ("kf", "flash_attention.cu", "src/repro/kernels/flash_attention.py:26"),
    # the gradient of the forward's function: the reference differentiates attend
    "flash_attention_backward": ("kf", "flash_attention_bwd.cu", "src/repro/models/layers.py:188"),
    # the SSD's training route, forward and backward: the reference differentiates ssd_chunked
    "ssd_chunked_grad": ("ks", "ssd_scan.cu", "src/repro/models/ssm.py:52"),
    "ssd_chunked_grad_backward": ("ks", "ssd_scan_bwd.cu", "src/repro/models/ssm.py:52"),
    # Mamba-2's causal conv, bias and SiLU, forward and backward: the reference's plain
    # _causal_conv under jax.grad
    "causal_conv_silu": ("kc", "causal_conv.cu", "src/repro/models/ssm.py:42"),
    "causal_conv_silu_backward": ("kc", "causal_conv.cu", "src/repro/models/ssm.py:42"),
}
SSD_SCORING = (4, 2048, 32, 64, 1, 128, 256)  # B, S, H, P, G, N, chunk of mamba2-370m scoring
SSD_LONG = (1, 32768, 32, 64, 1, 128, 256)  # one 32k sequence
SSD_TRAIN = (32, 2048, 32, 64, 1, 128, 256)  # mamba2-370m's train cell: 2 peers x 16 x 2048 folded
MAMBA_LAYERS = 48  # mamba2-370m's layers: each runs 2 SSD forwards (remat) and 1 backward a step
# the zamba2-7b benchmark cell (2 peers x 2 x 4096 folded): its SSD (112 heads of 64 in 2 groups, N
# 64) in 24 layers, and its shared blocks' attention (32 heads of 224 at scale (224 / 2)^-1/2) in 4
SSD_ZAMBA2_7B = (4, 4096, 112, 64, 2, 64, 256)
ZAMBA2_7B_LAYERS = 24
FLASH_ZAMBA2_7B = (4, 4096, 32, 224)
ZAMBA2_7B_APPLICATIONS = 4
# the causal conv of both LM cells, on the x|B|C view of in_proj's output: (B, S, C, the
# projection's width, x's first column, taps)
CONV_MAMBA2 = (32, 2048, 2304, 4384, 2048, 4)
CONV_ZAMBA2_7B = (4, 4096, 7424, 14704, 7168, 4)
PROMPT, GEN = 512, 32  # the serve path
FLASH_SCORING = (1, 8192, 8, 4, 256)  # B, S, H, K, D of gemma2-2b scoring: its full context
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0  # the local layers' window, the attention softcap
LONG_PROMPT, LONG_GEN = 6144, 16  # a prompt past the window: the local caches roll
SSD_FLAGS = {"use_ssd_kernel": True}  # mamba2's scoring forward through the SSD kernel
QWEN_HEADS = (16, 2, 128)  # H, K, D of qwen2.5-3b
SSD_ZAMBA = (4, 2048, 64, 64, 1, 64, 256)  # zamba2-1.2b scoring: d_inner 4096 = 64 heads of 64, N 64
GRANITE_FLASH = (2, 2048, 2048, 24, 8, 64)  # granite-moe-3b-a800m's heads: GQA groups of 3
ZAMBA_FLASH = (2, 2048, 2048, 32, 32, 64)  # zamba2-1.2b's shared attention: MHA
SCORING_BATCH = (4, 2048)  # zamba2 and granite scoring
MOONSHOT_SEQ = 2048  # moonshot-v1-16b-a3b scoring, 1 sequence
# whisper-base: scoring rows of (1500 frames, 448 tokens: Whisper's text
# context, n_text_ctx), a serve prompt of its 4-token start-of-transcript
# prefix and 64 greedy tokens, and 8 rows per peer on its train path
WHISPER_ROWS, WHISPER_TEXT, WHISPER_PROMPT, WHISPER_GEN, WHISPER_TRAIN_ROWS = 16, 448, 4, 64, 8
VLM_TEXT, VLM_PROMPT, VLM_GEN = 2048, 512, 16  # internvl2-26b: scoring tokens, serve prompt, tokens
TRAIN_PEERS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 4, 3e-3  # the LM train paths, per peer batch 1


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def wrapper(mods, name):
    """The wrapper that counts ``name``'s launches, or None in a checkout
    without it (the SRC modes run earlier checkouts)."""
    return getattr(mods.get(KERNELS[name][0]), name, None)


def reset_counters(mods) -> None:
    for name in KERNELS:
        if wrapper(mods, name) is not None:
            wrapper(mods, name).launches = 0


def read_counters(mods) -> dict:
    return {name: getattr(wrapper(mods, name), "launches", 0) for name in KERNELS}


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------


def check_quantize(torch, kq, x, u, s):
    """Norms within rtol 1e-5; levels identical except inside the band
    |u - frac| < s * 1e-5 around a rounding boundary (frac from the plain
    version), where they may differ by at most 1."""
    lev_k, nrm_k = kq.qsgd_quantize(x, u, s)
    lev_p, nrm_p = kq.quantize_plain(x, u, s)
    torch.cuda.synchronize()
    require(
        bool(torch.all((nrm_k - nrm_p).abs() <= 1e-5 * nrm_p.abs())),
        f"quantize norms outside rtol 1e-5 at {tuple(x.shape)}",
    )
    r = x.abs() / torch.clamp_min(nrm_p, 1e-30)[:, None] * s
    frac = r - torch.floor(r)
    band = (u - frac).abs() < s * 1e-5
    diff = (lev_k.to(torch.int32) - lev_p.to(torch.int32)).abs()
    require(bool(torch.all(diff[~band] == 0)), f"quantize levels differ outside the band at {tuple(x.shape)}")
    require(bool(torch.all(diff <= 1)), f"quantize levels differ by more than 1 at {tuple(x.shape)}")
    return float((nrm_k - nrm_p).abs().max()), int((diff > 0).sum()), int(band.sum())


def check_dequantize(torch, kq, levels, norms, s):
    out_k = kq.qsgd_dequantize(levels, norms, s)
    out_p = kq.dequantize_plain(levels, norms, s)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), f"dequantize not bit-identical at {tuple(levels.shape)}")
    return float((out_k - out_p).abs().max())


def kernel_phase(torch, kq):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    results = {"qsgd_quantize": [0.0, 0], "qsgd_dequantize": [0.0, 0]}
    # (rows, bucket, s, offset): 301 and a 4-byte offset take the kernels'
    # element-wise path, the rest their 16-byte vector path
    cases = [(FC2_ROWS, BUCKET, S, 0), (13, 256, S, 0), (13, 256, 7, 0), (5, 301, S, 0),
             (13, 256, S, 1), (4, BUCKET, S, 0)]
    for nb, bucket, s, offset in cases:
        x = (torch.randn((nb * bucket + offset,), generator=g, device="cuda") * 0.01)[offset:]
        x = x.view(nb, bucket)
        if nb == 4:
            x.zero_()  # all-zero buckets
        else:
            x[nb // 2].zero_()  # one zero bucket among live ones
        u = torch.rand((nb * bucket + offset,), generator=g, device="cuda")[offset:].view(nb, bucket)
        nerr, flips, in_band = check_quantize(torch, kq, x, u, s)
        lev, nrm = kq.quantize_plain(x, u, s)
        shifted = torch.empty((nb * bucket + offset,), dtype=torch.int8, device="cuda")[offset:]
        lev = shifted.view(nb, bucket).copy_(lev)
        derr = check_dequantize(torch, kq, lev, nrm, s)
        if nb == 4:
            require(bool(torch.all(lev == 0)), "all-zero bucket must quantize to zero levels")
        q, d = results["qsgd_quantize"], results["qsgd_dequantize"]
        q[0], q[1] = max(q[0], nerr), q[1] + flips
        d[0] = max(d[0], derr)
        print(
            f"kernel check ({nb} x {bucket}, s={s}, offset {offset}): quantize norm max_abs_err={nerr:.3e} "
            f"boundary flips={flips} (elements in band: {in_band}); "
            f"dequantize max_abs_err={derr:.3e}"
        )
    return results


def check_dequant_reduce(torch, kq, peers, nb, bucket, offset=0):
    """Bit-identical to the plain version: both round the scale, each
    product and each partial sum in the Pallas kernel's order."""
    g = torch.Generator(device="cuda")
    g.manual_seed(nb)
    n = peers * nb * bucket
    lev = torch.randint(-S, S + 1, (n + offset,), generator=g, device="cuda",
                        dtype=torch.int8)[offset:].view(peers, nb, bucket)
    nrm = torch.rand((peers, nb), generator=g, device="cuda")
    nrm[0, nb // 2] = 0.0  # an all-zero bucket
    w = torch.rand((peers,), generator=g, device="cuda")
    out_k = kq.qsgd_dequant_reduce(lev, nrm, w, S)
    out_p = kq.dequant_reduce_plain(lev, nrm, w, S)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), f"dequant_reduce not bit-identical at {(peers, nb, bucket)}")
    err = float((out_k - out_p).abs().max())
    print(f"kernel check dequant_reduce ({peers}, {nb}, {bucket}), offset {offset}: "
          f"max_abs_err={err:.3e}")
    return err


def topk_leaf(torch, n, kind, seed, rows=None):
    """A (n,) leaf, or a (rows, n) bank of such leaves, ~ 0.01 N, shaped by
    ``kind``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    shape = (n,) if rows is None else (rows, n)
    x = torch.randn(shape, generator=g, device="cuda") * 0.01
    flat = x.view(-1)
    if kind == "ties":
        x = torch.round(x * 400) / 400  # many exact magnitude ties
    elif kind == "mostly_zero":
        x[torch.rand(shape, generator=g, device="cuda") < 0.97] = 0.0
        x[..., 3], x[..., 11] = 1e-25, -3e-38  # below max * 2**-64: the bracket stays open
    elif kind == "zeros":
        x.zero_()
    elif kind == "nan":  # the max is NaN: no entry is kept
        flat[n // 2] = float("nan")
    elif kind == "denormal":  # every magnitude below 2**-126
        x = x * 1e-38
    elif kind == "inf":  # +inf among finite entries (n = 2, k = 1: lo = hi = inf)
        flat[0] = float("inf")
    elif kind == "infs":  # more +inf entries than k
        flat[1: 7 * n // 8: n // 8] = float("inf")
    elif kind == "equal":  # every magnitude equal, signs mixed
        x = torch.where(x < 0, -0.25, 0.25)
    return x


def check_select(torch, kt, x, k, kind):
    """Values and indices identical to the plain version (the Pallas
    kernel's bisection and slot order); every slot the pack fills holds
    x[index] and every other slot (a NaN leaf's) value 0 and index 0."""
    v, i = kt.topk_select_pack(x, k)
    pv, pi = kt.select_pack_plain(x, k)
    torch.cuda.synchronize()
    require(torch.equal(i, pi), f"select indices differ at n={x.numel()} k={k} ({kind})")
    require(torch.equal(v, pv), f"select values differ at n={x.numel()} k={k} ({kind})")
    kept = (v != 0) | (i != 0)
    require(torch.equal(v[kept], x[i[kept].long()]), f"select values are not x[idx] at n={x.numel()} k={k}")
    print(f"kernel check select n={x.numel()} k={k} ({kind}): identical values and indices "
          f"({int(kept.sum())} slots other than (0, 0))")
    return 0.0


def check_select_bank(torch, kt, x, k, kind):
    """One bank launch over a (P, n) bank: each row identical to the plain
    version and to ``topk_select_pack`` of that row alone."""
    before = kt.topk_select_pack.launches
    v, i = kt.topk_select_pack_bank(x, k)
    require(kt.topk_select_pack.launches == before + 1, f"bank ({tuple(x.shape)}) took "
            f"{kt.topk_select_pack.launches - before} launches, not one")
    for p in range(x.shape[0]):
        pv, pi = kt.select_pack_plain(x[p], k)
        sv, si = kt.topk_select_pack(x[p], k)
        torch.cuda.synchronize()
        require(torch.equal(i[p], pi) and torch.equal(v[p], pv),
                f"bank {tuple(x.shape)} k={k} ({kind}): row {p} differs from the plain version")
        require(torch.equal(i[p], si) and torch.equal(v[p], sv),
                f"bank {tuple(x.shape)} k={k} ({kind}): row {p} differs from its own select")
    return f"({x.shape[0]}, {x.shape[1]}) k={k}"


def mobilenet_leaf_sizes(torch):
    """The element counts of mobilenet-v3-small's 180 leaves at CIFAR
    shape, as the device step's bank holds them."""
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset

    ds = make_dataset("cifar")
    cfg = dataclasses.replace(get_config("mobilenet-v3-small"), image_size=ds.image_hw,
                              image_channels=ds.channels, num_classes=ds.num_classes)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return [p.numel() for p in model.parameters()]


def topk_k(n: int) -> int:
    """The exchange's k at the main path's fraction (``TopKExchange._k``)."""
    return max(1, min(n, round(n * TOPK_FRAC)))


def same_bits(torch, a, b) -> bool:
    """a and b hold NaN at the same positions and the same bit pattern
    everywhere else (so +0.0 and -0.0 differ)."""
    nan = a.isnan()
    return a.shape == b.shape and torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


def scatter_rows_plain(kt, vbank, vals, idx, W, n):
    """The bank's rows one by one through the plain version: the mixes,
    then (with ``vals``) each peer's own image, 0 + vals[p] * 1."""
    rows = [kt.scatter_accum_plain(vbank, idx, w, n) for w in W]
    one = W.new_ones((1,))
    if vals is not None:
        rows += [kt.scatter_accum_plain(vals[p:p + 1], idx[p:p + 1], one, n) for p in range(vals.shape[0])]
    return rows


def check_scatter_bank(torch, kt, vbank, vals, idx, W, n, what, body=0):
    """One launch over the bank (``body`` 0: the body the wrapper picks, else
    that body forced), every row bit-identical to the plain version (NaN at
    the same positions). Returns the largest abs error off the NaNs."""
    before = kt.topk_scatter_accum.launches
    if body:
        out = kt.scatter_launch(vbank, vals, idx, W, n, body)
        rows = list(out)
    else:
        mixed, own = kt.topk_scatter_accum_bank(vbank, vals, idx, W, n)
        rows = list(mixed) + ([] if own is None else list(own))
        body = kt.scatter_body(W.shape[0], *vbank.shape, n, vals is not None)
    require(kt.topk_scatter_accum.launches == before + 1,
            f"scatter bank {what} took {kt.topk_scatter_accum.launches - before} launches, not one")
    plain = scatter_rows_plain(kt, vbank, vals, idx, W, n)
    torch.cuda.synchronize()
    require(len(rows) == len(plain), f"scatter bank {what}: {len(rows)} rows, not {len(plain)}")
    err = 0.0
    for r, (got, want) in enumerate(zip(rows, plain)):
        require(same_bits(torch, got, want), f"scatter bank {what} body {body}: row {r} differs "
                f"from the plain version")
        live = ~want.isnan()
        if bool(live.any()):
            err = max(err, float((got[live] - want[live]).abs().max()))
    return err, body


def select_payload(torch, kt, n, peers, seed, k=None):
    """A bank as the device step hands it to the scatter: the select of a
    (peers, n) leaf ~ 0.01 N at k (default: the main path's), as (the
    values rounded through bf16, as a bf16 wire rounds them; the values
    unrounded; the indices)."""
    x = topk_leaf(torch, n, "normal", seed=seed, rows=peers)
    vals, idx = kt.topk_select_pack_bank(x, k or topk_k(n))
    return vals.to(torch.bfloat16).float(), vals, idx


def special_payload(torch, n, k, peers, seed):
    """A bank of ``peers`` x k pairs (k >= 9) at n where peer 0 holds -0.0,
    +inf, NaN and -inf values and indices below 0 and at or past n, peer 1
    a NaN leaf's payload (every slot value 0 at index 0), and the others
    random pairs, two of them at peer 0's -0.0 and +inf indices."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    idx = torch.stack([torch.randperm(n, generator=g, device="cuda")[:k] for _ in range(peers)])
    vals = torch.randn((peers, k), generator=g, device="cuda")
    vals[0, :5] = torch.tensor([-0.0, float("inf"), float("nan"), float("-inf"), -0.0])
    idx[0, 5:9] = torch.tensor([-1, -7, n, n + 100])
    if peers > 1:
        vals[1], idx[1] = 0.0, 0
    for p in range(2, peers):  # distinct within the peer: peer 0's two indices, then others
        rest = idx[p][(idx[p] != idx[0, 0]) & (idx[p] != idx[0, 1])][: k - 2]
        idx[p] = torch.cat([idx[0, :2], rest])
        vals[p, 0] = -0.0
    idx = idx.to(torch.int32).contiguous()
    return vals.to(torch.bfloat16).float(), vals, idx


def mixing_rows(torch, graph: str, peers: int):
    """The exchange's mixing weights (M, P) f32 on the card: one row of 1/P
    on the full graph, the ring's Metropolis-Hastings rows otherwise."""
    if graph == "full":
        return torch.full((1, peers), 1.0 / peers, device="cuda")
    from repro_torch.core.graph import get_graph

    return torch.as_tensor(get_graph(graph, peers).mixing_matrix(), dtype=torch.float32, device="cuda")


def scatter_phase(torch, kt):
    """The scatter, every case bit-identical to the plain version row for
    row: the wrapper at P = 4 with shared indices (and both bodies forced);
    (1 mix + 4 own rows) banks, one launch each, at mobilenet-v3-small's
    distinct leaf sizes and at fc2/w (both bodies there); the body
    threshold - 1, at it and + 1 (the body the wrapper picks); ring mixing
    at P = 1, 3 and 4 with own rows; the special payloads at one tile and
    at a row of several ragged tiles, both bodies."""
    err = 0.0
    for n, k in ((FC2, FC2_K), (4097, 41), (7, 7)):
        err = max(err, check_scatter(torch, kt, n, k))
    sizes = sorted(set(mobilenet_leaf_sizes(torch)))
    bodies = {1: 0, 2: 0}
    for n in sizes:
        e, body = check_scatter_bank(torch, kt, *select_payload(torch, kt, n, PEERS, seed=n),
                                     mixing_rows(torch, "full", PEERS), n, f"({PEERS}, {n})")
        err, bodies[body] = max(err, e), bodies[body] + 1
    payload = select_payload(torch, kt, FC2, PEERS, seed=5)
    for body in (0, 1, 2):
        err = max(err, check_scatter_bank(torch, kt, *payload, mixing_rows(torch, "full", PEERS), FC2,
                                          f"fc2/w ({PEERS}, {FC2})", body)[0])
    print(f"kernel check scatter banks (1 mix + {PEERS} own rows), one launch each, every row "
          f"identical to the plain version: mobilenet-v3-small's {len(sizes)} distinct leaf sizes "
          f"(tile body {bodies[1]}, long-row body {bodies[2]}) and fc2/w (both bodies)")
    thr, tile = kt.scatter_tile_pairs_max(), kt.scatter_tile()
    # the limit on a block's pairs at 5 and 3 ragged tiles; the limit on all
    # blocks' reads at tiles x 2 x k (1 mix + 1 own row), k below thr
    tiles = 2
    while kt.scatter_tile_reads_max(2, tiles * tile) // (2 * tiles) >= thr:
        tiles += 1
    k0 = kt.scatter_tile_reads_max(2, tiles * tile) // (2 * tiles)
    cases = [(1, k, 4 * tile + 1) for k in (thr - 1, thr, thr + 1)]
    cases += [(PEERS, k, 3 * tile - 5) for k in (thr // PEERS, thr // PEERS + 1)]
    cases += [(1, k, tiles * tile) for k in (k0 - 1, k0, k0 + 1)]
    for peers, k, n in cases:
        e, body = check_scatter_bank(torch, kt, *select_payload(torch, kt, n, peers, seed=k, k=k),
                                     mixing_rows(torch, "full", peers), n, f"({peers}, {n}) k={k}")
        reads, reads_max = -(-n // tile) * 2 * peers * k, kt.scatter_tile_reads_max(1 + peers, n)
        want = 1 if peers * k <= thr and reads <= reads_max else 2
        require(body == want, f"scatter at {peers} x {k} pairs into {n}: body {body}, not {want}")
        err = max(err, e)
        print(f"kernel check scatter at the body limits ({thr} pairs a block, {reads_max} pairs all "
              f"blocks): {peers} x {k} pairs into n={n} ({reads} reads): body {body}, identical")
    for peers in (1, 3, PEERS):
        for n in (4097, 589824):
            payload = select_payload(torch, kt, n, peers, seed=peers + n)
            for body in (1, 2):
                err = max(err, check_scatter_bank(torch, kt, *payload, mixing_rows(torch, "ring", peers), n,
                                                  f"ring P={peers} ({peers}, {n})", body)[0])
        for n in (4097, 100003):
            for graph in ("full", "ring"):
                payload = special_payload(torch, n, 64, peers, seed=n + peers)
                for body in (1, 2):
                    err = max(err, check_scatter_bank(torch, kt, *payload, mixing_rows(torch, graph, peers),
                                                      n, f"special {graph} P={peers} n={n}", body)[0])
    print("kernel check scatter banks with ring mixing (P = 1, 3, 4; n = 4097, 589824) and special "
          "payloads (-0.0, +inf, NaN, -inf values, indices below 0 and past n, a NaN leaf's "
          "payload; full and ring mixing; n = 4097, 100003), own rows, both bodies: every row "
          "identical, NaN at the same positions")
    return err


def check_scatter(torch, kt, n, k, peers=PEERS):
    """Bit-identical to the plain version: peers added in order p = 0..P-1,
    every product rounded before its add; both bodies, peers sharing
    indices."""
    g = torch.Generator(device="cuda")
    g.manual_seed(k)
    pool = torch.randperm(n, generator=g, device="cuda")[: min(n, 2 * k)]
    idx = torch.stack([pool[torch.randperm(pool.numel(), generator=g, device="cuda")[:k]]
                       for _ in range(peers)]).to(torch.int32).contiguous()
    vals = torch.randn((peers, k), generator=g, device="cuda")
    w = torch.rand((peers,), generator=g, device="cuda")
    out_k = kt.topk_scatter_accum(vals, idx, w, n)
    out_p = kt.scatter_accum_plain(vals, idx, w, n)
    torch.cuda.synchronize()
    require(same_bits(torch, out_k, out_p), f"scatter not bit-identical at P={peers} k={k} n={n}")
    err = float((out_k - out_p).abs().max())
    for body in (1, 2):
        err = max(err, check_scatter_bank(torch, kt, vals, None, idx, w[None], n,
                                          f"P={peers} k={k} n={n} shared indices", body)[0])
    print(f"kernel check scatter P={peers} k={k} n={n} (shared indices), the wrapper's body "
          f"{kt.scatter_body(1, peers, k, n, False)} and both forced: max_abs_err={err:.3e}")
    return err


def new_kernel_phase(torch, kq, kt):
    errs = {"qsgd_dequant_reduce": 0.0, "topk_select_pack": 0.0, "topk_scatter_accum": 0.0}
    for peers, nb, bucket, offset in ((PEERS, FC2_ROWS, BUCKET, 0), (3, 13, 256, 0),
                                      (PEERS, 5, 301, 0), (2, 13, 256, 1)):
        errs["qsgd_dequant_reduce"] = max(errs["qsgd_dequant_reduce"],
                                          check_dequant_reduce(torch, kq, peers, nb, bucket, offset))
    small = kt.small_row_max()  # the longest row of the one-block body
    cases = [(FC2, FC2_K, "normal"), (301, 3, "normal"), (4097, 41, "ties"),
             (4097, 2000, "ties"), (4097, 41, "mostly_zero"), (301, 3, "zeros"),
             (4097, 4097, "normal"), (16, 1, "normal"), (1, 1, "normal"), (2, 1, "inf"),
             (4097, 41, "inf"), (4097, 3, "infs"), (4097, 41, "nan"), (4097, 41, "denormal"),
             (4097, 41, "equal")]
    for n in (small - 1, small, small + 1):  # both bodies, either side of the threshold
        cases.append((n, topk_k(n), "normal"))
    for kind in ("ties", "mostly_zero", "nan", "denormal", "inf", "infs", "equal"):
        cases.append((small + 1, topk_k(small + 1), kind))  # the grid body
    for n, k, kind in cases:
        check_select(torch, kt, topk_leaf(torch, n, kind, seed=n + k), k, kind)
    sizes = sorted(set(mobilenet_leaf_sizes(torch)))
    banks = [check_select_bank(torch, kt, topk_leaf(torch, n, "normal", seed=n, rows=PEERS),
                               topk_k(n), "normal") for n in sizes]
    banks.append(check_select_bank(torch, kt, topk_leaf(torch, FC2, "normal", seed=5, rows=PEERS),
                                   FC2_K, "normal"))
    print(f"kernel check select banks, one launch each, every row identical to the plain version "
          f"and to its own select: mobilenet-v3-small's {len(sizes)} distinct leaf sizes and "
          f"fc2/w: {', '.join(banks)}")
    errs["topk_scatter_accum"] = scatter_phase(torch, kt)
    return errs


def ssd_inputs(torch, shape, dtype, seed=0):
    """x, dt, A, B, C as the reference's kernel test draws them: x ~ 0.5 N,
    dt = 0.2 softplus(N), A = -exp(0.3 N), B and C ~ 0.3 N."""
    Bsz, S_, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = (rand(Bsz, S_, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rand(Bsz, S_, H)) * 0.2
    A = -torch.exp(rand(H) * 0.3)
    return x, dt, A, (rand(Bsz, S_, G, N) * 0.3).to(dtype), (rand(Bsz, S_, G, N) * 0.3).to(dtype)


def ssd_kernel_phase(torch, ks):
    """The SSD kernel against its plain version on the same inputs, both
    bodies: bf16 inputs run the tensor-core body, f32 the CUDA-core one.
    Not bit-identical: the kernel's cumsum and dot products sum in another
    order, and the bf16 body's f32 operands enter as bf16 hi + lo. At the
    small shapes every element within atol 2e-5 + rtol 2e-4 (the
    reference's own Pallas-vs-oracle tolerance); at the full-width scoring
    shape and one 32k sequence, where a 128-deep product meets 256-step
    sums, the max abs error within 2e-5 of max|y|; likewise at zamba2-1.2b's
    scoring shape (4, 2048, 64 heads, P 64, N 64)."""
    worst = 0.0
    cases = ((SSD_SCORING, torch.bfloat16), (SSD_SCORING, torch.float32),
             ((1, 80, 8, 32, 4, 16, 32), torch.float32),  # padded last chunk, 4 groups
             ((2, 64, 4, 64, 1, 32, 64), torch.float32),  # a single chunk
             (SSD_LONG, torch.bfloat16),
             ((1, 80, 8, 32, 4, 16, 32), torch.bfloat16),
             ((2, 64, 4, 64, 1, 32, 64), torch.bfloat16),
             ((1, 32, 2, 16, 1, 8, 16), torch.bfloat16),  # chunk 16 under a 64-row tile, N 8
             (SSD_ZAMBA, torch.bfloat16), (SSD_ZAMBA, torch.float32))
    for shape, dtype in cases:
        args = ssd_inputs(torch, shape, dtype, seed=shape[1])
        y = ks.ssd_scan(*args, chunk=shape[-1])
        ref = ks.ssd_scan_plain(*args, chunk=shape[-1])
        torch.cuda.synchronize()
        require(y.shape == ref.shape == shape[:4] and y.dtype == torch.float32,
                f"ssd_scan output {tuple(y.shape)} {y.dtype} at {shape}")
        err = (y - ref).abs()
        scale = float(ref.abs().max())
        if shape in (SSD_SCORING, SSD_LONG, SSD_ZAMBA):
            require(float(err.max()) <= 2e-5 * scale, f"ssd_scan max abs error {float(err.max()):.3e} "
                    f"> 2e-5 * max|y| ({scale:.3e}) at {shape} {dtype}")
            tol = "max abs <= 2e-5 max|y|"
        else:
            require(bool(torch.all(err <= 2e-5 + 2e-4 * ref.abs())),
                    f"ssd_scan outside atol 2e-5 + rtol 2e-4 at {shape} {dtype}")
            tol = "every element within atol 2e-5 + rtol 2e-4"
        worst = max(worst, float(err.max()))
        print(f"kernel check ssd_scan {shape} {str(dtype).split('.')[-1]}: max_abs_err="
              f"{float(err.max()):.3e}, relative to max|y| {float(err.max()) / scale:.3e} "
              f"(max|y| {scale:.3f}; {tol})")
    return worst


def flash_inputs(torch, B, Sq, Skv, H, K, D, dtype, seed=0):
    """q, k, v ~ 0.5 N, as the reference's kernel test draws them."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rand = lambda *s: (torch.randn(s, generator=g, device="cuda") * 0.5).to(dtype)
    return rand(B, Sq, H, D), rand(B, Skv, K, D), rand(B, Skv, K, D)


def flash_tolerance(torch, ref, dtype):
    """Per-element limit on |kernel - plain| for inputs of ``dtype``; ``ref``
    is the plain version in f32. f32: the reference's own atol 2e-5 + rtol
    2e-4. bf16: ``ref`` comes before the output's one rounding to bf16, and
    the limit is that rounding, 2^-8 |ref|, plus 2e-5 max|ref| for the f32
    sums the two add in other orders."""
    if dtype == torch.float32:
        return 2e-5 + 2e-4 * ref.abs(), "every element within atol 2e-5 + rtol 2e-4"
    return (2.0 ** -8 * ref.abs() + 2e-5 * float(ref.abs().max()),
            "every element within 2^-8 |o| + 2e-5 max|o| of the plain version in f32")


def planted_faults(torch, kf, q, k, v, *, causal, softcap, window, scale=None):
    """Outputs of a kernel with a planted fault, made with the plain version
    on q, k and v in f32 and rounded to q's dtype as the kernel rounds:
    the key tile [S/2, S/2 + 64) skipped, and, when windowed, the window one
    key too wide."""
    Sq, Skv = q.shape[1], k.shape[1]
    f = [t.float() for t in (q, k, v)]
    qpos, kpos = torch.arange(Sq, device=q.device), torch.arange(Skv, device=k.device)
    t0 = Skv // 2 // 64 * 64
    skipped = torch.where((kpos >= t0) & (kpos < t0 + 64), -1, kpos)
    faults = {f"key tile [{t0}, {t0 + 64}) skipped": (skipped, window)}
    if causal and window:
        faults[f"window {window + 1}"] = (kpos, window + 1)
    for name, (kv_positions, w) in faults.items():
        yield name, kf.attend(*f, causal=causal, q_positions=qpos, kv_positions=kv_positions,
                              window=w if causal else 0, softcap_val=softcap,
                              scale=scale).to(q.dtype)


def check_flash(torch, kf, q, k, v, what, *, causal=True, softcap=0.0, window=0, faults=None,
                scale=None):
    """The flash kernel against its plain version on the same inputs, within
    ``flash_tolerance``. ``faults="require"``: each of ``planted_faults``
    must fall outside that limit; ``"report"``: print how far outside.
    Returns the largest abs error."""
    out = kf.flash_attention(q, k, v, causal=causal, softcap=softcap, window=window, scale=scale)
    ref = kf.flash_attention_plain(*(t.float() for t in (q, k, v)), causal=causal, softcap=softcap,
                                   window=window, scale=scale)
    torch.cuda.synchronize()
    require(out.shape == ref.shape == (*q.shape[:3], q.shape[3]) and out.dtype == q.dtype,
            f"flash_attention output {tuple(out.shape)} {out.dtype} at {what}")
    tol, rule = flash_tolerance(torch, ref, q.dtype)
    err = (out.float() - ref).abs()
    require(bool(torch.all(err <= tol)), f"flash_attention outside the limit at {what}: "
            f"max err/limit {float((err / tol).max()):.3f}")
    worst = float(err.max())
    print(f"kernel check flash_attention {what} {str(q.dtype).split('.')[-1]}: max_abs_err={worst:.3e}, "
          f"max err/limit {float((err / tol).max()):.3f} (max|o| {float(ref.abs().max()):.3f}; {rule})")
    if faults:
        for name, bad in planted_faults(torch, kf, q, k, v, causal=causal, softcap=softcap,
                                        window=window, scale=scale):
            bad_err = (bad.float() - ref).abs()
            ratio = float((bad_err / tol).max())
            require(faults == "report" or ratio > 1, f"the flash check at {what} would pass a "
                    f"planted fault ({name}): max err/limit {ratio:.3f}")
            print(f"  planted fault ({name}): max_abs_err={float(bad_err.max()):.3e}, "
                  f"max err/limit {ratio:.3f}, {int((bad_err > tol).sum())} elements outside "
                  f"({'rejected' if ratio > 1 else 'NOT rejected'})")
    return worst


def fused_qkv(torch, B, S_, H, K, D, seed):
    """q, k and v as strided views of one (B, S, (H + 2K) D) bf16 tensor, as
    a fused projection would hand them over."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = (torch.randn((B, S_, (H + 2 * K) * D), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    q = x[..., :H * D].unflatten(-1, (H, D))
    k = x[..., H * D:(H + K) * D].unflatten(-1, (K, D))
    v = x[..., (H + K) * D:].unflatten(-1, (K, D))
    return q, k, v


def flash_kernel_phase(torch, kf):
    """The flash kernel's cases. bf16 runs the tensor-core body, f32 the
    CUDA-core one; every case below S 8192 runs in both (granite-moe's GQA
    groups of 3 and zamba2's MHA at 2 x 2048 among them), and the bf16 body
    also at each headdim it is built for, at a window narrower than a key
    tile, and on strided views."""
    B, S_, H, K, D = FLASH_SCORING
    bf16, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    both = (  # (B, Sq, Skv, H, K, D), causal, softcap, window
        ((B, 1000, 1000, H, K, D), True, GEMMA_SOFTCAP, 300),  # ragged tiles
        ((1, 300, 500, 8, 4, 128), False, 30.0, 100),  # the window is ignored
        ((2, 256, 256, 4, 2, 32), True, 0.0, 0),
        ((2, 256, 256, 4, 2, 64), True, 0.0, 64),
        ((2, 256, 256, 16, 2, 128), True, 0.0, 0),
        ((1, 1024, 1024, 32, 32, 64), True, 0.0, 0),  # MHA
        (GRANITE_FLASH, True, 0.0, 0),  # granite-moe-3b-a800m: GQA groups of 3
        (ZAMBA_FLASH, True, 0.0, 0),  # zamba2-1.2b's shared attention
    )
    cases = (  # (B, Sq, Skv, H, K, D), dtype, causal, softcap, window
        ((B, S_, S_, H, K, D), bf16, True, GEMMA_SOFTCAP, GEMMA_WINDOW),
        ((B, S_, S_, H, K, D), bf16, True, GEMMA_SOFTCAP, 0),
        ((B, 1024, 1024, H, K, D), f32, True, GEMMA_SOFTCAP, GEMMA_WINDOW),
        ((B, 1024, 1024, H, K, D), f32, True, GEMMA_SOFTCAP, 0),
        *((shape, dtype, *rest) for shape, *rest in both for dtype in (f32, bf16)),
        ((2, 200, 200, H, K, D), bf16, True, GEMMA_SOFTCAP, 40),  # Sq % 128 != 0, window < 64
        *(((1, 300, 300, 4, 2, d), bf16, True, 0.0, 0) for d in (96, 160, 192, 224)),
    )
    for shape, dtype, causal, cap, window in cases:
        q, k, v = flash_inputs(torch, *shape, dtype, seed=shape[1] + shape[5])
        what = f"{shape} causal={causal} softcap={cap} window={window}"
        worst = max(worst, check_flash(torch, kf, q, k, v, what, causal=causal, softcap=cap,
                                       window=window, faults="require" if shape[1] == S_ else None))
    q, k, v = fused_qkv(torch, 2, 700, H, K, D, seed=7)
    worst = max(worst, check_flash(
        torch, kf, q, k, v, f"strided views of one fused (2, 700, {(H + 2 * K) * D}) tensor, "
        f"q strides {q.stride()}, causal=True softcap={GEMMA_SOFTCAP} window=256",
        softcap=GEMMA_SOFTCAP, window=256))
    return worst


def grad_guard_phase(torch, kf, ks):
    """With grad mode on and an input that requires grad: flash attention
    differentiates through its kernels (one forward launch, one backward
    launch, gradients within 2e-5 + 2e-4 |g| of the plain backward's in
    f32); the SSD scan, which has no backward kernel (reference behaviour
    18: the reference's Pallas scan has no gradient either), raises
    RuntimeError before any launch (its counter unchanged), and the same
    call under ``torch.inference_mode()`` launches once."""
    q, k, v = flash_inputs(torch, 1, 256, 256, 4, 2, 64, torch.float32, seed=11)
    q.requires_grad_(True)
    do = torch.randn_like(q)
    before = (kf.flash_attention.launches, kf.flash_attention_backward.launches)
    (dq,) = torch.autograd.grad(kf.flash_attention(q, k, v, softcap=5.0, window=100), (q,), do)
    ref = kf.flash_attention_backward_plain(q.detach(), k, v, do, softcap=5.0, window=100)[0]
    torch.cuda.synchronize()
    after = (kf.flash_attention.launches, kf.flash_attention_backward.launches)
    require(after == (before[0] + 1, before[1] + 1),
            f"flash_attention under grad mode: launches {before} -> {after}, not one of each")
    require(bool(torch.all((dq - ref).abs() <= 2e-5 + 2e-4 * ref.abs())),
            f"flash_attention's dq beyond 2e-5 + 2e-4 |g|: {float((dq - ref).abs().max()):.3e}")
    print(f"kernel check flash_attention with q requiring grad: one forward and one backward "
          f"launch, dq max_abs_err={float((dq - ref).abs().max()):.3e} against the plain backward")
    args = [t.detach() for t in ssd_inputs(torch, (1, 64, 4, 32, 1, 16, 32), torch.float32, seed=11)]
    args[0].requires_grad_(True)
    before = ks.ssd_scan.launches
    try:
        ks.ssd_scan(*args, chunk=32)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    torch.cuda.synchronize()
    require("reference behaviour 18" in refused, f"ssd_scan under grad mode did not refuse: {refused!r}")
    require(ks.ssd_scan.launches == before, "ssd_scan launched before refusing grad mode")
    with torch.inference_mode():
        out = ks.ssd_scan(*args, chunk=32)
    torch.cuda.synchronize()
    require(ks.ssd_scan.launches == before + 1 and bool(torch.isfinite(out).all()),
            f"ssd_scan under inference_mode: {ks.ssd_scan.launches - before} launches")
    print("kernel check ssd_scan with an input requiring grad: RuntimeError (reference behaviour "
          "18) under grad mode with no launch; one launch under inference_mode")


def flash_bwd_inputs(torch, B, Sq, Skv, H, K, D, dtype, seed=0):
    """q, k ~ 2 N (scores of a few units, where the softcap's derivative
    departs from 1), v ~ 0.5 N, and the output's cotangent do ~ N."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rand = lambda sd, *s: (torch.randn(s, generator=g, device="cuda") * sd).to(dtype)
    return rand(2.0, B, Sq, H, D), rand(2.0, B, Skv, K, D), rand(0.5, B, Skv, K, D), \
        rand(1.0, B, Sq, H, D)


def flash_bwd_tolerance(torch, ref, dtype):
    """Per-element limit on |kernel - autograd| for a gradient ``ref`` (f32
    autograd of the plain version on the same inputs). f32: 2e-4 |g| + 1e-5
    max|g| (sums over up to 8192 keys in other orders). bf16: the kernel
    computes in f32 and rounds once to bf16, 2^-8 |g|, plus 2e-5 max|g|,
    as ``flash_tolerance``."""
    top = float(ref.abs().max())
    if dtype == torch.float32:
        return 2e-4 * ref.abs() + 1e-5 * top, "2e-4 |g| + 1e-5 max|g|"
    return 2.0 ** -8 * ref.abs() + 2e-5 * top, "2^-8 |g| + 2e-5 max|g|"


def autograd_of_plain(torch, kf, q, k, v, do, *, causal, softcap, window, kv_positions=None,
                      straight_through=False):
    """dq, dk, dv by autograd of the plain attention in f32 on q, k, v.
    ``kv_positions`` (-1 masks a key) and ``straight_through`` (the softcap
    applied with the derivative of the identity) plant faults."""
    f = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    Sq, Skv = q.shape[1], k.shape[1]
    if straight_through:
        B, _, H, D = q.shape
        K = k.shape[2]
        u = torch.einsum("bqkgd,bskd->bkgqs", f[0].reshape(B, Sq, K, H // K, D) / math.sqrt(D), f[1])
        s = u + (torch.tanh(u / softcap) * softcap - u).detach()
        i, j = torch.arange(Sq, device=q.device)[:, None], torch.arange(Skv, device=q.device)[None]
        ok = (i >= j) & ((i - j < window) if window else True) if causal else (j >= 0)
        p = torch.softmax(torch.where(ok, s, -math.inf), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, f[2]).reshape(B, Sq, H, D)
    else:
        kpos = torch.arange(Skv, device=k.device) if kv_positions is None else kv_positions
        o = kf.attend(*f, causal=causal, q_positions=torch.arange(Sq, device=q.device),
                      kv_positions=kpos, window=window if causal else 0, softcap_val=softcap)
    return torch.autograd.grad(o, f, do.float())


def check_flash_stats(torch, kf, q, k, v, what, *, causal, softcap, window):
    """The bf16 forward's saved statistics against ``flash_attention_stats_plain``
    in f32 on the same inputs: lse within 4e-6 |lse| + 2e-5 (f32 sums of the
    exponentials in another order, exp2 within 2 ulp, scores of up to 50
    log units) and -inf on the same rows; o in f32 within the f32 forward's
    own limit, 2e-5 + 2e-4 |o|, of the plain o before its rounding."""
    _, o32, lse = kf.FlashAttentionFn.apply(q, k, v, causal, float(softcap), window)
    ro, rl = kf.flash_attention_stats_plain(*(t.float() for t in (q, k, v)), causal=causal,
                                            softcap=softcap, window=window)
    torch.cuda.synchronize()
    fin = torch.isfinite(rl)
    require(lse.shape == rl.shape and torch.equal(torch.isfinite(lse), fin),
            f"flash lse {tuple(lse.shape)}: not -inf on the plain lse's rows at {what}")
    lse_err = float((lse - rl)[fin].abs().max()) if bool(fin.any()) else 0.0
    require(bool(torch.all((lse - rl)[fin].abs() <= 4e-6 * rl[fin].abs() + 2e-5)),
            f"flash lse outside 4e-6 |lse| + 2e-5 at {what}: max abs err {lse_err:.3e}")
    o_tol, _ = flash_tolerance(torch, ro, torch.float32)
    require(bool(torch.all((o32 - ro).abs() <= o_tol)), f"flash o in f32 outside 2e-5 + 2e-4 |o| "
            f"at {what}: max abs err {float((o32 - ro).abs().max()):.3e}")
    print(f"  forward's lse max_abs_err={lse_err:.3e} (4e-6 |lse| + 2e-5), o in f32 "
          f"max_abs_err={float((o32 - ro).abs().max()):.3e} (2e-5 + 2e-4 |o|) of the plain "
          f"statistics in f32")


def check_flash_bwd(torch, kf, q, k, v, do, what, *, causal=True, softcap=0.0, window=0,
                    faults=False):
    """The backward kernel against autograd of the plain version on the same
    inputs, dq, dk and dv each within ``flash_bwd_tolerance``; in bf16 a
    second call must give the same bits (no atomics) and the forward's
    saved statistics must hold (``check_flash_stats``). ``faults``:
    gradients of a dropped softcap derivative, an ignored window and a
    skipped key tile must each fall outside that limit. Returns the largest
    abs error."""
    got = kf.flash_attention_backward(q, k, v, do, causal=causal, softcap=softcap, window=window)
    ref = autograd_of_plain(torch, kf, q, k, v, do, causal=causal, softcap=softcap, window=window)
    torch.cuda.synchronize()
    if q.dtype == torch.bfloat16:
        again = kf.flash_attention_backward(q, k, v, do, causal=causal, softcap=softcap,
                                            window=window)
        require(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                    for a, b in zip(got, again)),
                f"flash_attention_backward at {what}: two calls gave different bits")
        del again
    worst, ratios = 0.0, []
    for name, g, r, t in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        require(g.shape == t.shape and g.dtype == t.dtype, f"{name} {tuple(g.shape)} {g.dtype} at {what}")
        tol, rule = flash_bwd_tolerance(torch, r, q.dtype)
        err = (g.float() - r).abs()
        ratios.append(float((err / tol).max()))
        require(ratios[-1] <= 1, f"flash_attention_backward {name} outside the limit at {what}: "
                f"max err/limit {ratios[-1]:.3f}")
        worst = max(worst, float(err.max()))
    print(f"kernel check flash_attention_backward {what} {str(q.dtype).split('.')[-1]}: "
          f"max_abs_err={worst:.3e}, max err/limit dq {ratios[0]:.3f} dk {ratios[1]:.3f} dv "
          f"{ratios[2]:.3f} ({rule} of autograd of the plain version in f32)"
          + ("; a second call the same bits" if q.dtype == torch.bfloat16 else ""))
    if q.dtype == torch.bfloat16:
        check_flash_stats(torch, kf, q, k, v, what, causal=causal, softcap=softcap, window=window)
    if faults:
        Skv = k.shape[1]
        t0 = Skv // 2 // 64 * 64
        kpos = torch.arange(Skv, device=k.device)
        planted = {f"key tile [{t0}, {t0 + 64}) skipped":
                   dict(kv_positions=torch.where((kpos >= t0) & (kpos < t0 + 64), -1, kpos))}
        if softcap:
            planted["softcap derivative dropped"] = dict(straight_through=True)
        if causal and window:
            planted["window ignored"] = dict(window=0)
        for name, kw in planted.items():
            opts = dict(causal=causal, softcap=softcap, window=window)
            opts.update((key, val) for key, val in kw.items() if key in opts)
            bad = autograd_of_plain(torch, kf, q, k, v, do, **opts,
                                    **{key: val for key, val in kw.items() if key not in opts})
            ratio = max(float(((b.to(q.dtype).float() - r).abs()
                               / flash_bwd_tolerance(torch, r, q.dtype)[0]).max())
                        for b, r in zip(bad, ref))
            require(ratio > 1, f"the backward check at {what} would pass a planted fault ({name}): "
                    f"max err/limit {ratio:.3f}")
            print(f"  planted fault ({name}): max err/limit {ratio:.3f} (rejected)")
    return worst


def print_ptxas(source: str, report: str) -> None:
    """Each kernel's registers and spills in ``ptxas -v``'s report of
    ``source``; the tensor-core bodies (``*_wgmma<D>``) must spill nothing."""
    entry = re.compile(r"Compiling entry function '\w*?((?:bwd|flash)_[a-z_]+)I(?:Li(\d+)E|f)E")
    name, rows = None, []
    for line in report.splitlines():
        found = entry.search(line)
        if found:
            name = found.group(1) + (f"<{found.group(2)}>" if found.group(2) else "<float>")
        elif name and "spill stores" in line:
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append((name, regs, spills))
            require("wgmma" not in name or not any(spills),
                    f"ptxas: {name} in {source} spills {spills[0]} bytes stored, {spills[1]} loaded")
            name = None
    require(any("wgmma" in n for n, _, _ in rows), f"ptxas: no tensor-core kernel in {source}")
    print(f"ptxas {source}: " + "; ".join(f"{n} {r} registers, spills {s[0]}/{s[1]} bytes"
                                          for n, r, s in rows))


def flash_bwd_phase(torch, kf):
    """The backward kernel's cases, in f32 (the CUDA-core body) and bf16
    (the tensor-core body): gemma2-2b's heads (8 over 4, D 256, softcap 50)
    at S 8192, global and with the local layers' window of 4096, with
    planted faults, and at a ragged S 1000 with a window of 300; qwen2.5-3b's
    heads (16 over 2, D 128) at a ragged S 1000; Sq 300 against Skv 500
    without causal masking; D 32 and 64 with a window narrower than a key
    tile and with a softcap; granite-moe-3b-a800m's heads (24 over 8, D 64)
    and zamba2-1.2b's (32, MHA, D 64) at 2 x 2048; in bf16 also D 96, 160,
    192 and 224, so that every instance of the tensor-core body runs."""
    B, S_, H, K, D = FLASH_SCORING
    Hq, Kq, Dq = QWEN_HEADS
    both = (torch.float32, torch.bfloat16)
    cases = (  # (B, Sq, Skv, H, K, D), causal, softcap, window, faults, dtypes
        ((B, S_, S_, H, K, D), True, GEMMA_SOFTCAP, GEMMA_WINDOW, True, both),
        ((B, S_, S_, H, K, D), True, GEMMA_SOFTCAP, 0, True, both),
        ((2, 1000, 1000, H, K, D), True, GEMMA_SOFTCAP, 300, False, both),
        ((2, 1000, 1000, Hq, Kq, Dq), True, 0.0, 0, False, both),
        ((1, 300, 500, 8, 4, 128), False, 30.0, 100, False, both),  # the window is ignored
        ((2, 200, 200, 4, 2, 32), True, 0.0, 20, False, both),
        ((2, 333, 333, 4, 1, 64), True, 10.0, 0, False, both),
        (GRANITE_FLASH, True, 0.0, 0, False, both),  # granite-moe-3b-a800m: GQA groups of 3
        (ZAMBA_FLASH, True, 0.0, 0, False, both),  # zamba2-1.2b's shared attention
        *(((1, 300, 300, 4, 2, d), True, 5.0, 70, False, (torch.bfloat16,))
          for d in (96, 160, 192, 224)),
    )
    worst = 0.0
    for shape, causal, cap, window, faults, dtypes in cases:
        for dtype in dtypes:
            q, k, v, do = flash_bwd_inputs(torch, *shape, dtype, seed=shape[1] + shape[5])
            worst = max(worst, check_flash_bwd(
                torch, kf, q, k, v, do, f"{shape} causal={causal} softcap={cap} window={window}",
                causal=causal, softcap=cap, window=window, faults=faults))
            del q, k, v, do
            torch.cuda.empty_cache()
    return worst


def ssd_grad_inputs(torch, shape, seed: int):
    """``mamba2_apply``'s layout at ``shape`` (B, S, H, P, G, N, chunk): x, B
    and C bf16 slices of one convolution output, dt = 0.2 softplus(N), A =
    -exp(0.3 N), and a cotangent dy of y. Returns ((x, dt, A, B, C), dy)."""
    Bsz, S_, H, P, G, N, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    conv = (torch.randn((Bsz, S_, H * P + 2 * G * N), generator=g, device="cuda") * 0.5).bfloat16()
    x, Bm, Cm = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(torch.randn((Bsz, S_, H), generator=g, device="cuda")) * 0.2
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    dy = torch.randn((Bsz, S_, H, P), generator=g, device="cuda")
    return (x.unflatten(-1, (H, P)), dt, A, Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))), dy


def ssd_grad_phase(torch, ks, shape=SSD_TRAIN, what="mamba2-370m's train cell",
                   layers=MAMBA_LAYERS):
    """The SSD's training route at ``shape`` (B, S, H, P, G, N, chunk), by
    default mamba2-370m's train cell (SSD_TRAIN: 2 peers x 16 x 2048
    folded, 32 heads of 64, N 128, chunk 256), on the model's strided
    views: ``ssd_chunked_grad``'s y within 2e-5 of max|y| of the plain ``ssd_chunked``'s; ``ssd_chunked_grad_backward``'s dx, ddt,
    dA, dB and dC each within 5e-5 of its largest magnitude of autograd of
    ``ssd_chunked`` (x, B and C as f32 leaves of the same values), plus for
    dx, dB and dC, which the kernel writes in bf16, their rounding (2^-8 of
    the element): the card tests' limit (tests/test_torch_ssd_grad.py); a
    second backward the same bits. Then each half timed beside its plain
    version (plain, kernel, kernel, plain): the forward without grad (a
    remat group's forward; its recompute runs the same kernel) and the
    backward alone (the kernel's from the forward's saved states, the plain
    one through autograd's graph), against the bounds of ``ssd_scan_cost``
    and ``ssd_scan_bwd_cost``, and a train step's SSD reckoned as
    ``layers`` x (2 forwards + 1 backward). Returns ({name: max abs
    error}, {name: the kernels line's timing keys})."""
    Bsz, S_, H, P, G, N, Q = shape
    (x, dt, A, Bm, Cm), dy = ssd_grad_inputs(torch, shape, seed=21)
    with torch.no_grad():
        y = ks.ssd_chunked_grad(x, dt, A, Bm, Cm, Q)
    got = ks.ssd_chunked_grad_backward(x, dt, A, Bm, Cm, dy, Q)
    again = ks.ssd_chunked_grad_backward(x, dt, A, Bm, Cm, dy, Q)
    bits = lambda t: t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    require(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)),
            f"ssd_chunked_grad_backward at {shape[:6]}: a second call gave other bits")
    del again
    leaves = [t.detach().float().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    want_y = ks.ssd_chunked(*leaves, Q)[0]
    want = torch.autograd.grad(want_y, leaves, dy)
    y_err, y_scale = float((y - want_y.detach()).abs().max()), float(want_y.detach().abs().max())
    require(y_err <= 2e-5 * y_scale, f"ssd_chunked_grad at {shape[:6]}: y max abs error "
            f"{y_err:.3e} > 2e-5 x {y_scale:.3e}")
    del y, want_y
    worst, rel = 0.0, {}
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        scale = float(w.abs().max())
        err = (g.float() - w).abs()
        limit = 5e-5 * scale + (2.0 ** -8 * w.abs() if g.dtype == torch.bfloat16 else 0.0)
        bad = int((err > limit).sum())
        require(bad == 0, f"ssd_chunked_grad_backward at {shape[:6]}: {bad} elements of {name} "
                f"past 5e-5 x max|{name}| {scale:.3e}" + (" + its bf16 rounding" if g.dtype ==
                torch.bfloat16 else "") + f", worst {float(err.max()) / scale:.3e} of it")
        rel[name] = float(err.max()) / scale
        worst = max(worst, float(err.max()))
        del err, limit
    print(f"kernel check ssd_chunked_grad {shape[:4]} G={G} N={N} chunk {Q} bf16 on strided views "
          f"({what}, peers folded): y within {y_err / y_scale:.3e} of max|y| (limit "
          f"2e-5); backward against autograd of ssd_chunked: "
          + ", ".join(f"{n} {r:.3e}" for n, r in rel.items())
          + " of each gradient's largest magnitude (limit 5e-5, dx/dB/dC plus their bf16 rounding); "
          "a second backward the same bits")
    del got, want
    release(torch)

    args = (x, dt, A, Bm, Cm)

    def plain_fwd():
        with torch.no_grad():
            ks.ssd_chunked(*args, Q)

    def kern_fwd():
        with torch.no_grad():
            ks.ssd_chunked_grad(*args, Q)

    with torch.no_grad():
        _, split = ks.SsdChunkedFn.apply(*args, Q)
    kern_bwd = lambda: ks.SsdChunkedBackwardFn.apply(*args, split, dy, Q)
    y_plain = ks.ssd_chunked(*leaves, Q)[0]
    plain_bwd = lambda: torch.autograd.grad(y_plain, leaves, dy, retain_graph=True)
    rows, secs = {}, {}
    for name, plain, kern, cost in (
            ("ssd_chunked_grad", plain_fwd, kern_fwd, COST.ssd_scan_cost(x, Bm)),
            ("ssd_chunked_grad_backward", plain_bwd, kern_bwd, COST.ssd_scan_bwd_cost(x, Bm, Q))):
        t_plain1, _ = time_ms(torch, plain, 3)
        t_kern1, host1 = time_ms(torch, kern, 20)
        t_kern2, host2 = time_ms(torch, kern, 20)
        t_plain2, _ = time_ms(torch, plain, 3)
        ops, nbytes = cost
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}
        rows[name] = row
        print(f"timing {name} {shape[:4]} G={G} N={N} chunk {Q} bf16 ({what}): "
              f"kernel {t_kern1:.4f}/{t_kern2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
              f"{bytes_ms:.4f} ms, {ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s = {ops_ms:.4f} ms; roofline "
              f"share {row['bound_ms'] / row['ms']:.1%}), host enqueue {min(host1, host2) * 1e3:.1f} "
              f"us/call, library none: no single PyTorch call computes it")
    del y_plain, split
    release(torch)
    fwd, bwd = rows["ssd_chunked_grad"], rows["ssd_chunked_grad_backward"]
    reckon = lambda key: layers * (2 * fwd[key] + bwd[key]) / 1e3
    print(f"timing a train step's SSD at {what} ({layers} layers x (2 forwards + 1 "
          f"backward)): kernels {reckon('ms'):.4f} s, plain {reckon('plain_ms'):.4f} s")
    return {"ssd_chunked_grad": y_err, "ssd_chunked_grad_backward": worst}, rows


def zamba2_flash_phase(torch, kf):
    """The flash kernels at the zamba2-7b cell's attention (FLASH_ZAMBA2_7B:
    2 peers x 2 x 4096 folded, 32 MHA heads of 224, causal) at the
    release's scale (224 / 2)^-1/2: the forward within ``flash_tolerance``
    of the plain version in f32 at that scale, and the plain version at the
    default scale outside it (a ``scale`` the kernel dropped would pass
    unseen otherwise); the backward's dq, dk and dv within
    ``flash_bwd_tolerance`` of autograd of ``attend`` at that scale, the
    default-scale gradients outside it. Then each timed beside its plain
    version (plain, kernel, kernel, plain; the backward from the forward's
    saved statistics, as a train step calls it) against the frozen bounds,
    and a train step's flash reckoned as ZAMBA2_7B_APPLICATIONS x (2
    forwards + 1 backward). Returns ({name: max abs error}, {name: timing
    keys})."""
    B, S_, H, D = FLASH_ZAMBA2_7B
    scale = (D / 2) ** -0.5
    q, k, v = flash_inputs(torch, B, S_, S_, H, H, D, torch.bfloat16, seed=31)
    what = f"{FLASH_ZAMBA2_7B} causal scale (D / 2)^-1/2 (zamba2-7b's cell)"
    out = kf.flash_attention(q, k, v, causal=True, scale=scale)
    f = [t.float() for t in (q, k, v)]
    ref = kf.flash_attention_plain(*f, causal=True, scale=scale)
    tol, rule = flash_tolerance(torch, ref, torch.bfloat16)
    err = (out.float() - ref).abs()
    fwd_ratio = float((err / tol).max())
    require(fwd_ratio <= 1, f"flash_attention outside the limit at {what}: max err/limit {fwd_ratio:.3f}")
    fwd_err = float(err.max())
    dropped = float(((kf.flash_attention_plain(*f, causal=True).to(q.dtype).float() - ref).abs()
                     / tol).max())
    require(dropped > 1, f"the flash check at {what} would pass the default scale: {dropped:.3f}")
    print(f"kernel check flash_attention {what} bf16: max_abs_err={fwd_err:.3e}, max err/limit "
          f"{fwd_ratio:.3f} ({rule}); the default scale's output {dropped:.1f}x the limit (rejected)")
    del out, ref, err, tol
    release(torch)
    g = torch.Generator(device="cuda").manual_seed(32)
    do = torch.randn((B, S_, H, D), generator=g, device="cuda").to(torch.bfloat16)
    got = kf.flash_attention_backward(q, k, v, do, causal=True, scale=scale)
    pos = torch.arange(S_, device="cuda")

    def autograd(sc):
        leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
        o = kf.attend(*leaves, causal=True, q_positions=pos, kv_positions=pos, scale=sc)
        return torch.autograd.grad(o, leaves, do.float())

    want = autograd(scale)
    bwd_err, ratios = 0.0, []
    for name, gk, w in zip(("dq", "dk", "dv"), got, want):
        tol, rule = flash_bwd_tolerance(torch, w, torch.bfloat16)
        e = (gk.float() - w).abs()
        ratios.append(float((e / tol).max()))
        require(ratios[-1] <= 1, f"flash_attention_backward {name} outside the limit at {what}: "
                f"max err/limit {ratios[-1]:.3f}")
        bwd_err = max(bwd_err, float(e.max()))
    default = autograd(None)
    dropped = max(float(((b.to(q.dtype).float() - w).abs()
                         / flash_bwd_tolerance(torch, w, q.dtype)[0]).max())
                  for b, w in zip(default, want))
    require(dropped > 1, f"the backward check at {what} would pass the default scale: {dropped:.3f}")
    print(f"kernel check flash_attention_backward {what} bf16: max_abs_err={bwd_err:.3e}, max "
          f"err/limit dq {ratios[0]:.3f} dk {ratios[1]:.3f} dv {ratios[2]:.3f} ({rule} of autograd "
          f"of attend in f32); the default scale's gradients {dropped:.1f}x the limit (rejected)")
    del got, want, default
    release(torch)

    _, o32, lse = kf.FlashAttentionFn.apply(q, k, v, True, 0.0, 0, scale)
    plain_fwd = lambda: kf.flash_attention_plain(q, k, v, causal=True, scale=scale)
    kern_fwd = lambda: kf.FlashAttentionFn.apply(q, k, v, True, 0.0, 0, scale)
    kern_bwd = lambda: kf.FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, True, 0.0, 0, scale)
    plain_bwd = lambda: kf.flash_attention_backward_plain(q, k, v, do, causal=True, scale=scale)
    rows = {}
    for name, plain, kern, cost in (
            ("flash_attention", plain_fwd, kern_fwd, COST.flash_attention_cost(q, k, stats=True)),
            ("flash_attention_backward", plain_bwd, kern_bwd,
             COST.flash_attention_backward_cost(q, k))):
        t_plain1, _ = time_ms(torch, plain, 2)
        t_kern1, _ = time_ms(torch, kern, 10)
        t_kern2, _ = time_ms(torch, kern, 10)
        t_plain2, _ = time_ms(torch, plain, 2)
        release(torch)
        ops, nbytes = cost
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        rows[name] = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2),
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"timing {name} {what} bf16: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, plain "
              f"{t_plain1:.4f}/{t_plain2:.4f} ms, bound {rows[name]['bound_ms']:.4f} ms "
              f"({rows[name]['bound_by']}; {ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; roofline "
              f"share {rows[name]['bound_ms'] / rows[name]['ms']:.1%})")
    fwd, bwd = rows["flash_attention"], rows["flash_attention_backward"]
    print(f"timing a zamba2-7b train step's flash ({ZAMBA2_7B_APPLICATIONS} applications x (2 "
          f"forwards + 1 backward)): kernels "
          f"{ZAMBA2_7B_APPLICATIONS * (2 * fwd['ms'] + bwd['ms']):.3f} ms, bound "
          f"{ZAMBA2_7B_APPLICATIONS * (2 * fwd['bound_ms'] + bwd['bound_ms']):.3f} ms")
    del o32, lse, q, k, v, do
    release(torch)
    return {"flash_attention": fwd_err, "flash_attention_backward": bwd_err}, rows


def zamba2_kernel_phase(torch, ks, kf, kc):
    """The zamba2-7b cell's kernel shapes: the SSD's training route at
    SSD_ZAMBA2_7B (``ssd_grad_phase``: G = 2, 112 heads, N 64), the flash
    kernels at FLASH_ZAMBA2_7B with the release's scale
    (``zamba2_flash_phase``) and the causal conv's at CONV_ZAMBA2_7B
    (``conv_phase``). Returns ({name: max abs error}, {name: timing keys}),
    the kernels line's ``zamba2_7b`` entries."""
    errs, rows = ssd_grad_phase(torch, ks, SSD_ZAMBA2_7B, "zamba2-7b's cell", ZAMBA2_7B_LAYERS)
    for more_errs, more_rows in (zamba2_flash_phase(torch, kf),
                                 conv_phase(torch, kc, CONV_ZAMBA2_7B, "zamba2-7b's cell",
                                            ZAMBA2_7B_LAYERS)):
        errs.update(more_errs)
        rows.update(more_rows)
    return errs, rows


def conv_inputs(torch, shape, seed: int):
    """``mamba2_apply``'s layout at ``shape`` (B, S, C, width, col, K): x the
    (B, S, C) view at column ``col`` of a bf16 (B, S, width) projection, w
    (K, C) and b (C,) in bf16, and a cotangent dy of y in bf16."""
    Bsz, S_, C, width, col, K = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    proj = torch.randn((Bsz, S_, width), generator=g, device="cuda").bfloat16()
    w = (torch.randn((K, C), generator=g, device="cuda") * 0.3).bfloat16()
    b = (torch.randn((C,), generator=g, device="cuda") * 0.1).bfloat16()
    dy = torch.randn((Bsz, S_, C), generator=g, device="cuda").bfloat16()
    return proj[..., col:col + C], w, b, dy


def conv_phase(torch, kc, shape, what: str, layers: int):
    """The causal conv's kernels at ``shape`` (``conv_inputs``) on the
    projection's strided view: ``causal_conv_silu``'s y and
    ``causal_conv_silu_backward``'s dx, dw and db each within 1e-5 of its
    largest magnitude plus its rounding to bf16 (2^-8 of the element) of
    autograd of the plain ``causal_conv`` and SiLU in f32 on the same
    values (the card tests' limit, tests/test_torch_conv_grad.py); a second
    call of each the same bits. The plain bf16 version's y against the same
    limit is printed beside it. Then each timed beside its plain version
    (plain, kernel, kernel, plain): the forward without grad, the backward
    against autograd of the plain bf16 version through its retained graph,
    against the bounds of ``causal_conv_cost`` and ``causal_conv_bwd_cost``,
    and a train step's conv reckoned as ``layers`` x (2 forwards + 1
    backward). Returns ({name: max abs error}, {name: the kernels line's
    timing keys})."""
    F = torch.nn.functional
    K = shape[5]
    x, w, b, dy = conv_inputs(torch, shape, seed=41)
    with torch.no_grad():
        y, y_again = kc.causal_conv_silu(x, w, b), kc.causal_conv_silu(x, w, b)
        plain_y = F.silu(kc.causal_conv(x, w, b))
    got = kc.causal_conv_silu_backward(x, w, b, dy)
    again = kc.causal_conv_silu_backward(x, w, b, dy)
    bits = lambda t: t.view(torch.int16)
    require(torch.equal(bits(y), bits(y_again)) and all(torch.equal(bits(a), bits(r))
                                                        for a, r in zip(got, again)),
            f"causal_conv_silu at {shape[:3]}: a second call gave other bits")
    del y_again, again
    leaves = [t.detach().float().requires_grad_(True) for t in (x, w, b)]
    want_y = F.silu(kc.causal_conv(*leaves))
    want = torch.autograd.grad(want_y, leaves, dy.float())
    want_y = want_y.detach()
    del leaves
    ratios, errs = {}, {}
    for name, g, wt in (("y", y, want_y), ("dx", got[0], want[0]), ("dw", got[1], want[1]),
                        ("db", got[2], want[2]), ("plain y", plain_y, want_y)):
        err = (g.float() - wt).abs()
        ratios[name] = float((err / (1e-5 * float(wt.abs().max()) + 2.0 ** -8 * wt.abs())).max())
        errs[name] = float(err.max())
        del err
        if name != "plain y":
            require(ratios[name] <= 1, f"causal_conv_silu at {shape[:3]} ({what}): {name} max "
                    f"err/limit {ratios[name]:.3f} (1e-5 max|{name}| + 2^-8 |{name}|)")
    print(f"kernel check causal_conv_silu {shape[:3]} K={K} bf16 on the projection's view (row "
          f"{shape[3]}, column {shape[4]}; {what}): max err/limit y {ratios['y']:.3f}, dx "
          f"{ratios['dx']:.3f}, dw {ratios['dw']:.3f}, db {ratios['db']:.3f} (limit 1e-5 of the "
          f"largest magnitude + 2^-8 of the element, against autograd of the plain conv and SiLU "
          f"in f32); the plain bf16 version's y {ratios['plain y']:.3f}; a second call of each "
          f"the same bits")
    del y, got, want, want_y, plain_y
    release(torch)

    def plain_fwd():
        with torch.no_grad():
            F.silu(kc.causal_conv(x, w, b))

    def kern_fwd():
        with torch.no_grad():
            kc.causal_conv_silu(x, w, b)

    bf_leaves = [t.detach().requires_grad_(True) for t in (x, w, b)]
    y_plain = F.silu(kc.causal_conv(*bf_leaves))
    plain_bwd = lambda: torch.autograd.grad(y_plain, bf_leaves, dy, retain_graph=True)
    kern_bwd = lambda: kc.causal_conv_silu_backward(x, w, b, dy)
    rows = {}
    for name, plain, kern, cost in (
            ("causal_conv_silu", plain_fwd, kern_fwd, COST.causal_conv_cost(x, K)),
            ("causal_conv_silu_backward", plain_bwd, kern_bwd, COST.causal_conv_bwd_cost(x, K))):
        t_plain1, _ = time_ms(torch, plain, 5)
        t_kern1, host1 = time_ms(torch, kern, 20)
        t_kern2, host2 = time_ms(torch, kern, 20)
        t_plain2, _ = time_ms(torch, plain, 5)
        ops, nbytes = cost
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2),
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None}
        rows[name] = row
        print(f"timing {name} {shape[:3]} K={K} bf16 ({what}): kernel {t_kern1:.4f}/{t_kern2:.4f} "
              f"ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {nbytes / 1e6:.1f} MB at 3.35 TB/s), share of the bound "
              f"{row['bound_ms'] / row['ms']:.1%}, host enqueue {min(host1, host2) * 1e3:.1f} "
              f"us/call, library none: no single PyTorch call computes it")
    del y_plain, bf_leaves
    release(torch)
    fwd, bwd = rows["causal_conv_silu"], rows["causal_conv_silu_backward"]
    reckon = lambda key: layers * (2 * fwd[key] + bwd[key])
    print(f"timing a train step's causal conv at {what} ({layers} layers x (2 forwards + 1 "
          f"backward)): kernels {reckon('ms'):.3f} ms, bound {reckon('bound_ms'):.3f} ms, plain "
          f"{reckon('plain_ms'):.3f} ms")
    return {"causal_conv_silu": errs["y"],
            "causal_conv_silu_backward": max(errs["dx"], errs["dw"], errs["db"])}, rows


# ---------------------------------------------------------------------------
# 3. the card against the CPU on a small input
# ---------------------------------------------------------------------------


def reference_phase(torch):
    """A 4-peer squeezenet1.1 QSGD epoch on MNIST-shaped 8x8 data, on the
    card and on the CPU (plain versions), from the same init params and the
    same uniforms. Params agree within 1e-5, except where one quantization
    boundary flip explains the gap (gap <= lr * max bucket norm / s + 1e-5),
    on at most 1e-4 of all coordinates."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster, QSGDConfig
    from repro_torch.core import compression as C
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    lr, qcfg = 0.05, QSGDConfig(levels=7, bucket=256)
    draw = C.draw_uniforms
    params0, runs = None, {}
    for device in ("cpu", "cuda"):
        cpu_gen = torch.Generator().manual_seed(1)
        C.draw_uniforms = lambda shape, generator, _g=cpu_gen: torch.rand(
            shape, generator=_g).to(generator.device)
        try:
            cl = LocalP2PCluster(
                get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
                num_peers=4, batch_size=8, batches_per_epoch=1, optimizer=sgd(momentum=0.9),
                lr=lr, exchange="qsgd", qsgd=qcfg, seed=0, device=device, init_params=params0,
            )
            params0 = params0 or {k: v.cpu() for k, v in cl.peers[0].params.items()}
            cl.run_epoch_sync(0)
        finally:
            C.draw_uniforms = draw
        runs[device] = cl
    require(
        runs["cpu"].mailbox.stats == runs["cuda"].mailbox.stats
        and [p.comm_bytes_sent for p in runs["cpu"].peers] == [p.comm_bytes_sent for p in runs["cuda"].peers],
        "card vs CPU wire accounting differs",
    )
    worst, n_flip, n_all = 0.0, 0, 0
    for pc, pg in zip(runs["cpu"].peers, runs["cuda"].peers):
        for k in pc.params:
            gap = np.abs(pc.params[k].numpy() - pg.params[k].cpu().numpy())
            worst = max(worst, float(gap.max()))
            n_flip += int((gap > 1e-5).sum())
            n_all += gap.size
    max_norm = 0.0
    for r in range(4):
        _, payload = runs["cpu"].mailbox.consume(r).payload
        max_norm = max(max_norm, max(float(p["norms"].max()) for p in payload.values()))
    flip_gap = lr * max_norm / qcfg.levels + 1e-5
    require(worst <= flip_gap, f"card vs CPU params gap {worst:.3e} > one flip ({flip_gap:.3e})")
    require(n_flip <= 1e-4 * n_all, f"{n_flip} of {n_all} coordinates differ by more than 1e-5")
    print(
        f"reference check (squeezenet1.1, 4 peers, qsgd(7, 256), 1 epoch, card vs CPU): "
        f"params max_abs_err={worst:.3e}, coordinates beyond 1e-5: {n_flip} of {n_all}"
    )


def reference_step_phase(torch):
    """One device train step of 4 peers on squeezenet1.1 (MNIST-shaped
    8x8, batch 8 per peer, SGD with momentum), on the card and on the CPU
    from the same init params and uniforms, for qsgd(7, 256) + EF and for
    topk(0.05) + EF. cuDNN and oneDNN sum convolution gradients in other
    orders, so params and EF residuals agree within 1e-5, except where one
    boundary flip explains the gap (a QSGD rounding, or a top-k selection
    at a near tie): gap <= lr * flip + 1e-5 in params and flip + 1e-5 in
    the residual, on at most 1e-4 of all coordinates, with flip the largest
    norm / s or k-th magnitude of the run.

    One step, because later steps multiply a flip: under EF the flip's
    residual changes its bucket's norm (QSGD) or re-enters the next select
    (top-k), and the moved params shift every later gradient onto other
    near-ties. Card runs of 3 steps moved 104 (qsgd + EF) and 5,872 (topk
    + EF) of 726,474 params beyond 1e-5 (and 0 in a second run of the same
    topk steps, while the card's cuDNN algorithms were not yet pinned to
    deterministic ones). ``tests/test_torch_p2p.py`` holds 3 steps of both
    to the reference on the CPU, where the two sides' gradients are
    closer."""
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import QSGDConfig, Topology, TrainState, build_p2p_train_step
    from repro_torch.core import compression as C
    from repro_torch.core.simulate import cnn_loss
    from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro_torch.kernels import topk as kt
    from repro_torch.optim import sgd

    lr, steps = 0.05, 1
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=ds.num_classes)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, PEERS * 8)
    batches = [loader.load(BatchKey(0, 0, i)) for i in range(steps)]
    for topo in (Topology(exchange="qsgd", qsgd=QSGDConfig(7, 256), ef=True),
                 Topology(exchange="topk", topk_frac=0.05, ef=True)):
        runs, flips = {}, [0.0]
        for device in ("cpu", "cuda"):
            model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
            model = model.to(device).requires_grad_(False)
            params = {k: v.clone() for k, v in model.named_parameters()}
            loss_fn = lambda p, b, m=model: cnn_loss(m, p, b["images"], b["labels"])
            opt = sgd(momentum=0.9)
            step = build_p2p_train_step(loss_fn, opt, topo, PEERS, lambda s: lr, device=device)
            state = TrainState(params, opt.init(params), 0, torch.Generator(device=device).manual_seed(0))
            cpu_gen = torch.Generator().manual_seed(1)
            draw, select, reduce = C.draw_uniforms, kt.topk_select_pack, C.dequant_reduce
            C.draw_uniforms = lambda shape, generator, _g=cpu_gen: torch.rand(
                shape, generator=_g).to(generator.device)
            if device == "cpu":  # the largest move one flip can make, from the CPU run
                C.dequant_reduce = lambda lev, nrm, w, q: (
                    flips.append(float(nrm.max()) / q.levels), reduce(lev, nrm, w, q))[1]
                kt.topk_select_pack = lambda x, k: (lambda v, i: (
                    flips.append(float(v.abs().min())), (v, i))[1])(*select(x, k))
            try:
                for b in batches:
                    batch = {"images": models.images_to_device(b["images"], device),
                             "labels": torch.from_numpy(b["labels"].astype(np.int64))}
                    state, metrics = step(state, batch)
                    require(math.isfinite(float(metrics["loss"])), f"{topo.exchange} step loss not finite")
            finally:
                C.draw_uniforms, kt.topk_select_pack, C.dequant_reduce = draw, select, reduce
            runs[device] = state
        flip = max(flips)
        for what, bound in (("params", lr * flip), ("ef", flip)):
            ours, theirs = getattr(runs["cuda"], what), getattr(runs["cpu"], what)
            gaps = torch.cat([(ours[k].cpu() - theirs[k]).abs().reshape(-1) for k in theirs])
            worst, n_far = float(gaps.max()), int((gaps > 1e-5).sum())
            require(worst <= bound + 1e-5,
                    f"step {topo.exchange}: card vs CPU {what} gap {worst:.3e} > one flip ({bound:.3e})")
            require(n_far <= 1e-4 * gaps.numel(),
                    f"step {topo.exchange}: {n_far} of {gaps.numel()} {what} beyond 1e-5")
            print(f"reference check (squeezenet1.1 device step, 4 peers, {topo.exchange} + EF, "
                  f"{steps} step, card vs CPU): {what} max_abs_err={worst:.3e}, "
                  f"coordinates beyond 1e-5: {n_far} of {gaps.numel()}")


def reference_async_phase(torch):
    """The reference's churned async scenario (``analysis.trace``'s
    ``_run_cluster``: squeezenet1.1, MNIST-shaped 8x8, 2 peers, churn 0.3,
    ``sim_compute_s`` pinned, seed 11, 2 async epochs) on the card and on
    the CPU from the same init params: the trace digests are equal (same
    events, times and order), and params agree within 1e-5 (the allgather
    exchange has no boundary to flip)."""
    import dataclasses

    from repro_torch import models
    from repro_torch.analysis import TraceRecorder
    from repro_torch.analysis.trace import _run_cluster
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=10)
    model = models.init_model(cfg, generator=torch.Generator().manual_seed(11), device="cpu")
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    runs = {}
    for device in ("cpu", "cuda"):
        tracer = TraceRecorder()
        runs[device] = (tracer, _run_cluster(tracer, device=device, init_params=init))
    (tc, cc), (tg, cg) = runs["cpu"], runs["cuda"]
    require(tg.digest() == tc.digest(),
            f"async scenario: card trace {tg.digest()[:12]} != CPU trace {tc.digest()[:12]}")
    worst = max(float((pg.params[k].cpu() - pc.params[k]).abs().max())
                for pc, pg in zip(cc.peers, cg.peers) for k in pc.params)
    require(worst <= 1e-5, f"async scenario: card vs CPU params gap {worst:.3e} > 1e-5")
    print(f"reference check (squeezenet1.1 async cluster, 2 peers, churn 0.3, 2 epochs, card vs "
          f"CPU): trace digest {tg.digest()[:16]} on both ({len(tg)} events), drops "
          f"{[p.drops for p in cg.peers]}, clocks {[round(p.clock, 4) for p in cg.peers]} s, "
          f"params max_abs_err={worst:.3e}")


def stub_inputs(torch, cfg, rows: int, generator, device="cpu") -> dict:
    """The batch entries beside the tokens that the config's family reads:
    whisper's frames (rows, encoder_seq, d) and the VLM's patches (rows,
    vision_tokens, d), f32 normals from ``generator`` (the stubbed
    frontends' outputs, as the reference's tests draw them); none for the
    other LMs."""
    shapes = {"frames": cfg.encoder_seq, "patches": cfg.vision_tokens}
    return {k: torch.randn((rows, n, cfg.d_model), generator=generator, device=device)
            for k, n in shapes.items() if n}


def reference_lm_phase(torch, arch: str, seq: int, flags: dict):
    """A 3-layer reduced ``arch`` in f32, the same weights (one CPU
    generator seed) on the card and on the CPU: the forward with ``flags``
    (the CPU takes the kernels' plain versions), prefill logits and every layer's state (SSM and convolution
    states, or the K/V cache; whisper's cross K/V too), then 8 greedy
    decode steps. Whisper's batch carries frames and the VLM's patches
    (``stub_inputs``). Logits within
    atol 1e-4 + rtol 1e-4 and states within 1e-5 + rtol 1e-5 (f32 products
    summed in other orders by cuBLAS, the kernels and the CPU); greedy
    tokens identical."""
    import copy
    import dataclasses

    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve

    cfg = dataclasses.replace(reduced(get_config(arch), num_layers=3), dtype="float32")
    cpu_model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=torch.Generator().manual_seed(1))
    extra = stub_inputs(torch, cfg, 2, torch.Generator().manual_seed(2))
    cache = seq + 9 + (cfg.vision_tokens if "patches" in extra else 0)
    runs = {}
    for device, model in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        model.requires_grad_(False)
        batch = {"tokens": tokens, **{k: v.to(device) for k, v in extra.items()}}
        with torch.inference_mode():
            logits, _ = models.forward(model, batch, cfg, **flags)
            _, state = models.prefill(model, models.init_decode_state(cfg, 2, cache, device=device),
                                      batch, cfg)
        if extra:  # prefill, then 8 decode steps
            res = generate_with(torch, model, cfg, tokens.to(device),
                                {k: v for k, v in batch.items() if k != "tokens"}, 9, cache)
        else:
            res = serve.generate(model, cfg, tokens.to(device), 9)
        runs[device] = (logits.cpu(), dict(res, state=state))
    (lc, rc), (lg, rg) = runs["cpu"], runs["cuda"]
    close = lambda a, b, tol: bool(torch.all((a.cpu() - b.cpu()).abs() <= tol + tol * b.cpu().abs()))
    tag = f"reduced {arch}"
    require(close(lg, lc, 1e-4), f"{tag} forward: card vs CPU logits beyond 1e-4")
    require(close(rg["prefill_logits"], rc["prefill_logits"], 1e-4),
            f"{tag} prefill: card vs CPU logits beyond 1e-4")
    states = lambda r: r["state"]["self"] + [r["state"]["cross"]] if "self" in r["state"] \
        else r["state"]["layers"]
    for layer, (sg, sc) in enumerate(zip(states(rg), states(rc))):
        for k in sc:
            require(close(sg[k], sc[k], 1e-5), f"{tag} layer {layer} {k} state beyond 1e-5")
    require((rg["tokens"] == rc["tokens"]).all(), f"{tag}: greedy tokens differ, card vs CPU")
    err = float((lg - lc).abs().max())
    print(f"reference check ({tag}, 3 layers, f32, {seq} tokens"
          f"{''.join(f' + {k} {tuple(v.shape)}' for k, v in extra.items())}, card with "
          f"{flags or 'the flash kernel'} vs CPU): "
          f"forward logits max_abs_err={err:.3e}, prefill logits "
          f"{float((rg['prefill_logits'].cpu() - rc['prefill_logits']).abs().max()):.3e}, "
          f"states of {sorted(states(rc)[0])} within 1e-5"
          f"{' (and the cross K/V)' if 'cross' in rc['state'] else ''}, "
          f"8 greedy decode steps identical: {rg['tokens'][0].tolist()}")


def reference_train_phase(torch):
    """One train step of a 3-layer reduced gemma2-2b in f32 (S 160 over its
    window of 64) and of a 3-layer reduced mamba2-370m in f32 (S 160 over
    its chunk of 32, through ``ssd_chunked``), 2 peers x batch 2,
    ``allgather_mean``, from the same state on the card (gemma2: flash
    kernels forward and backward, folded over the peers) and on the CPU
    (the plain versions). Plain SGD at rate 1 makes each side's update its
    mean gradient: the two updates agree within 1e-4 of each leaf's largest
    magnitude (f32 products summed in other orders by cuBLAS, cuDNN, the
    kernels and the CPU), for mamba2 plus 1e-5 of the largest update of
    any leaf: the f32 rounding of a sum over the 640 tokens is about
    sqrt(640) x 2^-23 = 3e-6 of its terms' size, and a leaf whose updates
    are small beside the rest (a gated norm's scale, 1/36 of the largest)
    takes that rounding from terms of the others' size (1.192e-07 on the
    card, 1.1e-4 of its own magnitude). The losses agree within rtol 1e-5. The step donates its state,
    so each side starts from its own copy. Likewise a 3-layer reduced
    zamba2-1.2b (a Mamba-2 layer, one applying the shared attention block,
    a Mamba-2 tail layer; the mamba2 limit; the shared layer's unread params
    must not move on either side, reference behaviour 23) and a 3-layer
    reduced granite-moe-3b-a800m with the dense and with the capacity
    dispatch (its router aux in the loss); and a reduced whisper-base (2
    encoder and 3 decoder layers, remat on: every layer recomputed in the
    backward, the encoder's gradient through each decoder layer's cross
    K/V) with 64 frames a row, the mamba2 limit (its decoder's ``ln_cross``
    scales take updates of 1/75 of the largest, and 1.192e-07 apart on
    the card), and a 3-layer reduced internvl2-26b with 16 patches a row
    (``stub_inputs``), the gemma2 limit."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.p2p import Topology
    from repro_torch.optim import sgd
    from repro_torch.train import build_train_step, init_train_state

    for arch, floor, dispatch in (("gemma2-2b", 0.0, "dense"), ("mamba2-370m", 1e-5, "dense"),
                                  ("zamba2-1.2b", 1e-5, "dense"),
                                  ("granite-moe-3b-a800m", 0.0, "dense"),
                                  ("granite-moe-3b-a800m", 0.0, "capacity"),
                                  ("whisper-base", 1e-5, "dense"), ("internvl2-26b", 0.0, "dense")):
        cfg = dataclasses.replace(reduced(get_config(arch), num_layers=3), dtype="float32",
                                  remat=arch == "whisper-base")
        unread = unread_params(cfg)
        state = init_train_state(torch.Generator().manual_seed(0), cfg, sgd(), device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2 * TRAIN_PEERS, 161),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **stub_inputs(torch, cfg, 2 * TRAIN_PEERS, torch.Generator().manual_seed(2))}
        out = {}
        for device in ("cpu", "cuda"):
            st = state.replace(params={k: p.to(device, copy=True) for k, p in state.params.items()})
            step = build_train_step(cfg, sgd(), Topology(), TRAIN_PEERS, lambda s: 1.0,
                                    moe_dispatch=dispatch, device=device)
            new, metrics = step(st, batch)
            out[device] = ({k: state.params[k] - p.cpu() for k, p in new.params.items()},
                           float(metrics["loss"]))
        (dc, lc), (dg, lg) = out["cpu"], out["cuda"]
        tag = f"reduced {arch}" + (f" ({dispatch} dispatch)" if cfg.num_experts else "")
        require(abs(lg - lc) <= 1e-5 * abs(lc),
                f"{tag} train step: loss {lg} on the card, {lc} on the CPU")
        require(all(float(dc[k].abs().max()) == float(dg[k].abs().max()) == 0.0 for k in unread),
                f"{tag} train step: an unread param of a shared_attn layer moved")
        top = max(float(w.abs().max()) for w in dc.values())
        worst, worst_rel = 0.0, 0.0
        for k, want in dc.items():
            if k in unread:
                continue
            err, scale = float((dg[k] - want).abs().max()), float(want.abs().max())
            require(scale > 0, f"reduced {arch} train step: {k} did not move on the CPU")
            limit = 1e-4 * scale + floor * top
            require(err <= limit, f"reduced {arch} train step: {k} update {err:.3e} from the "
                    f"CPU's, beyond 1e-4 x {scale:.3e} + {floor:g} x {top:.3e}")
            worst, worst_rel = max(worst, err / limit), max(worst_rel, err / scale)
        via = {"gemma2-2b": "flash kernels", "mamba2-370m": "ssd_chunked, no kernel",
               "zamba2-1.2b": "flash kernels and ssd_chunked"}.get(arch, "flash kernels")
        print(f"reference check ({tag} train step, 3 layers, f32, {TRAIN_PEERS} peers x 2 "
              f"x 160 tokens"
              f"{''.join(f' + {k} {tuple(v.shape)}' for k, v in batch.items() if v.dim() == 3)}, "
              f"card ({via}) vs CPU): loss {lg:.6f} vs {lc:.6f}, every leaf's update "
              f"within {worst_rel:.3e} of its largest magnitude, {worst:.3f} of its limit (1e-4 of "
              f"it + {floor:g} of the largest update, {top:.3e})"
              + (f"; the {len(unread)} unread params of its shared_attn layers unmoved on both "
                 "sides" if unread else ""))


def unread_params(cfg):
    """The names of the params that the ``shared_attn`` layers own and never
    read (their ``ln1``, ``ln2`` and ``ffn``: reference behaviour 23)."""
    return {f"layers.{i}.{name}" for i, spec in enumerate(cfg.block_specs())
            if spec.mixer == "shared_attn"
            for name in ("ln1.scale", "ln2.scale", "ffn.w_gate.weight", "ffn.w_up.weight",
                         "ffn.w_down.weight")}


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def drive(torch, mods, arch: str, epochs: int, *, exchange: str = "qsgd", graph: str = "full",
          ef: bool = False, batches: int = 2, priced: bool = False, adversary: dict = None,
          reject_nonfinite: bool = False, check=None):
    """``LocalP2PCluster.run`` at full width; ``priced``: through a
    ``ServerlessExecutor`` on the AWS-default runtime with latency-driven
    memory, which times every batch with the card synchronised and prices
    the Lambda fan-out (accounting, not a measurement of Lambda), and the
    aggregators of a sharded protocol. ``adversary``: an ``AdversarySpec``'s
    fields. ``check(cluster, tag)`` runs the run's own checks after the
    launches are read."""
    from repro_torch.configs import get_config
    from repro_torch.core import (AdversarySpec, InstanceConfig, LocalP2PCluster, QSGDConfig,
                                  RuntimeConfig, ServerlessExecutor, compare_backends)
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    executor = ServerlessExecutor(backend="serverless", runtime=RuntimeConfig.aws_default(),
                                  allocation="latency") if priced else None
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = LocalP2PCluster(
        get_config(arch), make_dataset("cifar"), num_peers=PEERS, batch_size=32,
        batches_per_epoch=batches, optimizer=sgd(momentum=0.9), lr=0.01,  # table1_resource_stages.py
        exchange=exchange, qsgd=QSGDConfig(levels=S, bucket=BUCKET), topk_frac=TOPK_FRAC,
        graph=graph, ef=ef, seed=0, executor=executor, reject_nonfinite=reject_nonfinite,
        adversary=None if adversary is None else AdversarySpec(**adversary),
    )
    t1 = time.perf_counter()
    history = cluster.run(epochs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counters(mods)

    leaves = len(cluster.peers[0].params)
    decodes = epochs * (sum(cluster.graph.degree(r) for r in range(PEERS)) + (PEERS if ef else 0)) * leaves
    expect = dict.fromkeys(KERNELS, 0)
    if exchange == "qsgd":
        expect.update(qsgd_quantize=epochs * PEERS * leaves, qsgd_dequantize=decodes)
    elif exchange == "topk":
        expect.update(topk_select_pack=epochs * PEERS * leaves, topk_scatter_accum=decodes)
    tag = f"cluster {arch} {exchange} graph={graph} ef={ef}" + (
        f" priced ({batches} batches/epoch)" if priced else "") + (
        f" {cluster.adversary.describe()} on peers {cluster.adversary.attackers(PEERS)}"
        if adversary else "") + (" reject_nonfinite" if reject_nonfinite else "")
    require(launches == expect, f"{tag}: launches {launches} != expected {expect}")
    require(len(history) == epochs, f"{tag}: ran {len(history)} of {epochs} epochs")
    for h in history:
        require(all(math.isfinite(h[k]) for k in ("loss", "val_loss")), f"{tag}: non-finite loss {h}")
    for peer in cluster.peers:
        require(
            all(bool(torch.isfinite(v).all()) for v in peer.params.values()),
            f"{tag}: non-finite params on peer {peer.rank}",
        )
    n_params = sum(v.numel() for v in cluster.peers[0].params.values())
    print(
        f"path {tag}: {leaves} leaves, {n_params} params, setup {t1 - t0:.3f} s, "
        f"{epochs} epochs in {t2 - t1:.3f} s ({(t2 - t1) / epochs:.3f} s/epoch), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}"
    )
    for h in history:
        print(
            f"  epoch {h['epoch']}: loss={h['loss']:.4f} acc={h['acc']:.3f} "
            f"val_loss={h['val_loss']:.4f} val_acc={h['val_acc']:.3f}"
        )
    table = cluster.peers[0].metrics.table()
    print("  peer 0 stage means (Table I): " + ", ".join(
        f"{k}={table[k]['time_s']:.4f}s" for k in cluster.peers[0].metrics.STAGES
    ))
    print(f"  mailbox: {dict(sorted(cluster.mailbox.stats.items()))}")
    if check is not None:
        check(cluster, tag)
    if priced:
        for peer in cluster.peers:
            require(len(peer.reports) == epochs, f"{tag}: peer {peer.rank} has "
                    f"{len(peer.reports)} reports, not {epochs}")
            for rep in peer.reports:
                require(rep.num_batches == batches and len(rep.per_batch_s) == batches,
                        f"{tag}: peer {peer.rank} epoch {rep.epoch} priced {rep.num_batches} batches")
                require(rep.measured_compute_s == sum(rep.per_batch_s)
                        and min(rep.per_batch_s) > 0,
                        f"{tag}: peer {peer.rank} epoch {rep.epoch} batch times {rep.per_batch_s}")
                # the quickstart's comparison: the same batch times priced
                # sequentially on a steady-state t2.large
                irep = ServerlessExecutor(
                    backend="instance", instance="t2.large", instance_config=InstanceConfig.ideal(),
                ).simulate_instance(rep.per_batch_s)
                cmp = compare_backends(rep.cost_report(), irep.cost_report())
                rel = "faster" if cmp["speedup_pct"] >= 0 else "slower"
                print(
                    f"  peer {peer.rank} epoch {rep.epoch}: batches measured on the card "
                    f"{sum(rep.per_batch_s):.4f} s (max {max(rep.per_batch_s):.4f} s); simulated "
                    f"accounting of those times: {rep.num_batches} lambdas x "
                    f"{rep.lambda_memory_mb} MB, wall {rep.wall_time_s:.4f} s, cold starts "
                    f"{rep.num_cold_starts}, retries {rep.num_retries}, "
                    f"${rep.cost_usd:.8f}/peer/epoch; against a t2.large (ideal) "
                    f"{abs(cmp['speedup_pct']):.2f} % {rel} at {cmp['cost_multiple']:.2f}x the cost"
                )
    return launches


def drive_async(torch, mods, arch: str, epochs: int):
    """An async ``LocalP2PCluster.run`` at full width: top-k (1 %) with EF,
    the full graph, peer speeds 1 / 1.25 / 1.5 / 2, churn 0.2 with 0.5 s
    downtime, the measured compute times driving the event order, a
    ``TraceRecorder`` attached. Under async a consume can find nothing yet,
    so the scatter's launches follow the trace: one decode (a launch per
    leaf) per consume event, plus one own-image decode per publish (EF)."""
    from repro_torch.analysis import TraceRecorder, check_trace
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    tracer = TraceRecorder()
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = LocalP2PCluster(
        get_config(arch), make_dataset("cifar"), num_peers=PEERS, batch_size=32,
        batches_per_epoch=2, optimizer=sgd(momentum=0.9), lr=0.01, exchange="topk",
        topk_frac=TOPK_FRAC, ef=True, sync=False, peer_speeds=(1.0, 1.25, 1.5, 2.0),
        churn_prob=0.2, churn_downtime_s=0.5, tracer=tracer, seed=0,
    )
    t1 = time.perf_counter()
    history = cluster.run(epochs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counters(mods)

    leaves = len(cluster.peers[0].params)
    kinds = [ev[0] for ev in tracer.events]
    consumes, publishes = kinds.count("consume"), kinds.count("publish")
    expect = dict.fromkeys(KERNELS, 0)
    expect.update(topk_select_pack=epochs * PEERS * leaves,
                  topk_scatter_accum=(consumes + publishes) * leaves)
    tag = f"cluster {arch} topk graph=full ef=True async churn=0.2"
    require(publishes == epochs * PEERS, f"{tag}: {publishes} publishes, not {epochs * PEERS}")
    require(launches == expect, f"{tag}: launches {launches} != expected {expect}")
    require(all(p.steps_done == epochs for p in cluster.peers),
            f"{tag}: steps done {[p.steps_done for p in cluster.peers]}")
    errors = [f.render() for f in check_trace(tracer.events) if f.severity == "error"]
    require(not errors, f"{tag}: trace errors {errors}")
    for h in history:
        require(all(math.isfinite(h[k]) for k in ("loss", "val_loss")), f"{tag}: non-finite loss {h}")
    for peer in cluster.peers:
        require(all(bool(torch.isfinite(v).all()) for v in peer.params.values()),
                f"{tag}: non-finite params on peer {peer.rank}")
    print(
        f"path {tag}: {leaves} leaves, setup {t1 - t0:.3f} s, {epochs} epochs in {t2 - t1:.3f} s "
        f"({(t2 - t1) / epochs:.3f} s/epoch), {len(tracer)} trace events ({consumes} consumes, "
        f"{kinds.count('miss')} misses, {publishes} publishes), last epoch's order "
        f"{cluster.last_event_order}, virtual clocks "
        f"{[round(p.clock, 4) for p in cluster.peers]} s, drops {[p.drops for p in cluster.peers]}, "
        f"downtime {[round(p.downtime_s, 4) for p in cluster.peers]} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}"
    )
    return launches


def cifar_steps(torch, arch: str, steps: int):
    """A seeded ``arch`` on the card at CIFAR shape (frozen: the step
    differentiates its params dict), one copy of its params, the loss a
    step takes, and ``steps`` global batches of 4 peers x 32."""
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import cnn_loss
    from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset

    ds = make_dataset("cifar")
    cfg = dataclasses.replace(get_config(arch), image_size=ds.image_hw,
                              image_channels=ds.channels, num_classes=ds.num_classes)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, PEERS * 32)
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)
    params = {k: v.clone() for k, v in model.named_parameters()}
    batches = []
    for i in range(steps):
        b = loader.load(BatchKey(0, 0, i))
        batches.append({"images": models.images_to_device(b["images"], "cuda"),
                        "labels": torch.from_numpy(b["labels"].astype(np.int64)).cuda()})
    return params, lambda p, b: cnn_loss(model, p, b["images"], b["labels"]), batches


def run_steps(torch, step, state, batches):
    """Every batch through ``step`` -> (the last state, the losses, the host
    clock after each step, which the loss's read waits for, the state after
    the first step)."""
    losses, marks, first = [], [], None
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        marks.append(time.perf_counter())
        first = first or state
    torch.cuda.synchronize()
    return state, losses, marks, first


def drive_step(torch, mods, arch: str, steps: int, *, exchange: str, selects_per_leaf: int = 1,
               scatters_per_leaf: int = 1, profile: bool = False):
    """``build_p2p_train_step`` at full width: 4 peers x batch 32 on
    CIFAR-shaped data, SGD with momentum, lr 0.01, EF on; the first step is
    timed apart (cuDNN plans, first launches). The top-k exchange selects
    each leaf's (P, n) bank in one launch and scatters it into the mix and
    the P own images in one more (``selects_per_leaf`` = P and
    ``scatters_per_leaf`` = 2 for earlier checkouts that selected peer by
    peer or scattered the own images apart). ``profile``: one more
    step under ``torch.profiler``, its device busy share and kernel time
    by kind printed (after the launches are read)."""
    from repro_torch.core import QSGDConfig, Topology, TrainState, build_p2p_train_step
    from repro_torch.optim import sgd

    topo = Topology(exchange=exchange, qsgd=QSGDConfig(S, BUCKET), topk_frac=TOPK_FRAC, ef=True)
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, loss_fn, batches = cifar_steps(torch, arch, steps)
    opt = sgd(momentum=0.9)
    step = build_p2p_train_step(loss_fn, opt, topo, PEERS, lambda s: 0.01)
    state = TrainState(params, opt.init(params), 0, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, losses, marks, _ = run_steps(torch, step, state, batches)
    launches = read_counters(mods)

    leaves = len(params)
    expect = dict.fromkeys(KERNELS, 0)
    if exchange == "qsgd":
        expect.update(qsgd_quantize=steps * leaves, qsgd_dequant_reduce=steps * leaves,
                      qsgd_dequantize=steps * leaves)
    else:
        expect.update(topk_select_pack=steps * selects_per_leaf * leaves,
                      topk_scatter_accum=steps * scatters_per_leaf * leaves)
    tag = f"step {arch} {exchange} + EF"
    require(launches == expect, f"{tag}: launches {launches} != expected {expect}")
    require(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    require(all(bool(torch.isfinite(v).all()) for v in state.params.values()), f"{tag}: non-finite params")
    require(all(bool(torch.isfinite(v).all()) for v in state.ef.values()), f"{tag}: non-finite EF residual")
    require(all(v.shape == (PEERS, *params[k].shape) for k, v in state.ef.items()), f"{tag}: EF bank shape")
    steady = (marks[-1] - marks[0]) / (steps - 1)
    print(
        f"path {tag}: {leaves} leaves, {sum(v.numel() for v in params.values())} params, "
        f"{PEERS} peers x batch 32, setup {t1 - t0:.3f} s, first step {marks[0] - t1:.3f} s, "
        f"then {steady:.4f} s/step over {steps - 1} steps, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses {[round(x, 4) for x in losses]}, "
        f"launches {launches}"
    )
    if profile:
        print_profile(f"{tag} step", device_profile(torch, lambda: step(state, batches[-1])), {})
    return launches


# ---------------------------------------------------------------------------
# Robust, sharded and tree exchange
# ---------------------------------------------------------------------------

ADV_SIGN = dict(num=1, attack="sign_flip", scale=10.0, seed=1)  # AdversarySpec fields
ADV_NOISE = dict(num=1, attack="scaled_noise", scale=10.0, seed=2)
ADV_STALE = dict(num=1, attack="stale_replay", seed=2)


def params_gap(a, b) -> float:
    """The largest |a - b| over two lists of every peer's params."""
    return max(float((p[k] - q[k]).abs().max()) for p, q in zip(a, b) for k in p)


def poisoned(count: int):
    """A ``drive`` check: the mailbox counted ``count`` poisoned publishes."""
    def check(cluster, tag):
        got = cluster.mailbox.stats["poisoned_publishes"]
        require(got == count, f"{tag}: {got} poisoned publishes, not {count}")
    return check


def krum_excludes_the_attacker(torch):
    """A ``drive`` check: Krum over the bank of the last epoch's published
    gradients (each peer's mailbox register, decoded, in rank order) does
    not select the attacker's row."""
    from repro_torch.core import krum_scores, krum_select
    from repro_torch.core.robust import flatten_bank

    def check(cluster, tag):
        rows = []
        for r in range(PEERS):
            _, payload = cluster.mailbox.consume(r).payload
            rows.append(cluster.protocol.host_decode(payload, cluster.peers[r].params, cluster.xctx))
        flat, _ = flatten_bank({k: torch.stack([g[k] for g in rows]) for k in cluster.names})
        _, sel = krum_select(flat, m=1)
        (attacker,) = cluster.adversary.attackers(PEERS)
        scores = [f"{x:.4g}" for x in krum_scores(flat).tolist()]
        require(int(sel[0]) != attacker, f"{tag}: krum selected the attacker's row {attacker}")
        print(f"  krum over the last epoch's published bank {tuple(flat.shape)}: scores {scores}, "
              f"selects peer {int(sel[0])}, not the attacker {attacker}")
    return check


def sharded_checks(torch, arch: str, epochs: int, waves: int, shard_memory: bool):
    """A ``drive`` check of a priced sharded run: ``waves`` aggregation
    reports per epoch, each printed (the simulated aggregators' memory,
    wall and dollars: accounting of the reduce times measured on the card,
    not a measurement of Lambda); with ``shard_memory`` every aggregator's
    memory planned from shard bytes (the first epoch's is the planner's
    figure for a shard, the later ones never below it, and a model-sized
    plan would be larger); and params after the run's last epoch within
    1e-6 of an ``allgather_mean`` run of as many epochs from the same seed
    on the card (the port's CNN
    backward runs on deterministic cuDNN algorithms, so a run repeats
    itself bit for bit and the rail sees only the exchanges' sums)."""
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    def check(cluster, tag):
        reps = cluster.aggregation_reports
        require(len(reps) == epochs * waves,
                f"{tag}: {len(reps)} aggregation reports, not {epochs} x {waves}")
        plan = cluster.shard_plan
        shard_bytes = plan.shard_bytes(cluster.xctx.wire_dtype)
        planner = cluster.executor.planner
        from_shard = planner.lambda_memory_mb(model_bytes=shard_bytes, batch_bytes=shard_bytes)
        from_model = planner.lambda_memory_mb(model_bytes=cluster._model_bytes,
                                              batch_bytes=shard_bytes)
        print(f"  {plan.describe()}")
        for rep in reps:
            print(f"  aggregation wave, epoch {rep.epoch}: {rep.num_batches} aggregators, reduce "
                  f"times measured on the card {[round(t, 6) for t in rep.per_batch_s]} s; simulated "
                  f"accounting: {rep.lambda_memory_mb} MB each, wall {rep.wall_time_s:.4f} s, "
                  f"cold starts {rep.num_cold_starts}, ${rep.cost_usd:.8f}")
        if shard_memory:
            print(f"  aggregator memory planned from a shard: {from_shard} MB (from the model: "
                  f"{from_model} MB)")
            require(all(r.num_batches == PEERS for r in reps),
                    f"{tag}: aggregators per wave {[r.num_batches for r in reps]}, not {PEERS}")
            require(reps[0].lambda_memory_mb == math.ceil(from_shard / 64) * 64
                    and all(r.lambda_memory_mb >= from_shard for r in reps)
                    and from_model > from_shard,
                    f"{tag}: aggregator memory {[r.lambda_memory_mb for r in reps]} MB is not "
                    f"planned from shard bytes ({from_shard} MB; model {from_model} MB)")
        base = LocalP2PCluster(
            get_config(arch), make_dataset("cifar"), num_peers=PEERS, batch_size=32,
            batches_per_epoch=2, optimizer=sgd(momentum=0.9), lr=0.01,
            exchange="allgather_mean", seed=0,
        )
        base.run(epochs)
        gap = params_gap([p.params for p in cluster.peers], [p.params for p in base.peers])
        require(gap <= 1e-6, f"{tag}: params after {epochs} epochs {gap:.3e} from "
                f"allgather_mean's, above 1e-6")
        print(f"  params after {epochs} epochs within {gap:.3e} of an allgather_mean run from the "
              f"same seed (rail 1e-6)")
    return check


def drive_robust_step(torch, mods, arch: str, steps: int, *, exchange: str,
                      adversary: dict = None, rail: bool = False, profile: bool = False):
    """``build_p2p_train_step`` at full width with a robust or sharded
    protocol, no EF: 4 peers x batch 32 on CIFAR-shaped data, SGD with
    momentum, lr 0.01, the state's generator seeded (the scaled_noise
    attacker draws from it). These paths launch none of the port's kernels.
    ``rail``: after step 1, params within 1e-6 of an ``allgather_mean`` step
    from the same state and batch. ``profile``: one more step under
    ``torch.profiler``, its device idle share printed."""
    from repro_torch.core import AdversarySpec, Topology, TrainState, build_p2p_train_step
    from repro_torch.optim import sgd

    adv = None if adversary is None else AdversarySpec(**adversary)
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, loss_fn, batches = cifar_steps(torch, arch, steps)
    opt = sgd(momentum=0.9)
    step = build_p2p_train_step(loss_fn, opt, Topology(exchange=exchange), PEERS,
                                lambda s: 0.01, adversary=adv)
    state = TrainState(params, opt.init(params), 0, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, losses, marks, first = run_steps(torch, step, state, batches)
    launches = read_counters(mods)

    tag = f"step {arch} {exchange}" + (f" {adv.describe()} on peers {adv.attackers(PEERS)}"
                                       if adv else "")
    require(launches == dict.fromkeys(KERNELS, 0), f"{tag}: launches {launches}, expected none")
    require(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    require(all(bool(torch.isfinite(v).all()) for v in state.params.values()), f"{tag}: non-finite params")
    steady = (marks[-1] - marks[0]) / (steps - 1)
    print(
        f"path {tag}: {len(params)} leaves, {sum(v.numel() for v in params.values())} params, "
        f"{PEERS} peers x batch 32, setup {t1 - t0:.3f} s, first step {marks[0] - t1:.3f} s, "
        f"then {steady:.4f} s/step over {steps - 1} steps, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses {[round(x, 4) for x in losses]}"
    )
    if rail:
        base = build_p2p_train_step(loss_fn, opt, Topology(), PEERS, lambda s: 0.01)
        ref, _ = base(TrainState(params, opt.init(params), 0, None), batches[0])
        gap = max(float((first.params[k] - ref.params[k]).abs().max()) for k in params)
        require(gap <= 1e-6, f"{tag}: step 1 params {gap:.3e} from allgather_mean's, above 1e-6")
        print(f"  step 1 params within {gap:.3e} of an allgather_mean step from the same state "
              f"(rail 1e-6)")
    if profile:
        print_profile(f"{tag} step", device_profile(torch, lambda: step(state, batches[-1])), {})
    return launches


def robust_reference_phase(torch):
    """A reduced scenario on the card and on the CPU from the same init:
    squeezenet1.1 on MNIST-shaped 8x8, 4 peers x batch 8, SGD with
    momentum, 2 sync epochs, with ``trimmed_mean:0.25`` and a sign_flip
    attacker (scale 10), and with ``reduce_scatter``. cuDNN and oneDNN sum
    convolution gradients in other orders, so params agree within 1e-5,
    except where the trim keeps the attacker's row, which is 10 x a
    gradient and carries 10 x its gap: there within 1e-4, and beyond 1e-5
    on at most 1e-4 of the coordinates (reference behaviour 4). An order
    statistic that swaps two contributions closer than the gap moves the
    estimate by less than their difference, so it needs no bound of its
    own. Mailbox statistics and bytes sent are equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import AdversarySpec, LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    for exchange, adversary in (("trimmed_mean:0.25", ADV_SIGN), ("reduce_scatter", None)):
        runs, params0 = {}, None
        for device in ("cpu", "cuda"):
            cl = LocalP2PCluster(
                get_config("squeezenet1.1"), make_dataset("mnist", size=128, image_hw=8, channels=1),
                num_peers=PEERS, batch_size=8, batches_per_epoch=1, optimizer=sgd(momentum=0.9),
                lr=0.05, exchange=exchange, seed=0, device=device, init_params=params0,
                adversary=None if adversary is None else AdversarySpec(**adversary),
            )
            params0 = params0 or {k: v.cpu() for k, v in cl.peers[0].params.items()}
            cl.run(2)
            runs[device] = cl
        tag = f"squeezenet1.1, 4 peers, {exchange}" + (
            f" {runs['cpu'].adversary.describe()}" if adversary else "") + ", 2 epochs, card vs CPU"
        require(runs["cpu"].mailbox.stats == runs["cuda"].mailbox.stats
                and [p.comm_bytes_sent for p in runs["cpu"].peers]
                == [p.comm_bytes_sent for p in runs["cuda"].peers],
                f"{tag}: wire accounting differs")
        gaps = torch.cat([(pg.params[k].cpu() - pc.params[k]).abs().reshape(-1)
                          for pc, pg in zip(runs["cpu"].peers, runs["cuda"].peers) for k in pc.params])
        worst, n_far = float(gaps.max()), int((gaps > 1e-5).sum())
        bound = 10 * 1e-5 if adversary else 1e-5
        require(worst <= bound, f"{tag}: params gap {worst:.3e} > {bound:.0e}")
        require(n_far <= 1e-4 * gaps.numel(), f"{tag}: {n_far} of {gaps.numel()} beyond 1e-5")
        print(f"reference check ({tag}): params max_abs_err={worst:.3e} (bound {bound:.0e}), "
              f"coordinates beyond 1e-5: {n_far} of {gaps.numel()}, poisoned publishes "
              f"{runs['cuda'].mailbox.stats['poisoned_publishes']}")


# ---------------------------------------------------------------------------
# The per-peer device step and the CNN numerics
# ---------------------------------------------------------------------------


def drive_bank_step(torch, mods, arch: str, steps: int, *, exchange: str, graph: str = "full",
                    ef: bool = False, staleness: int = 1, adversary: dict = None):
    """``build_p2p_train_step`` with a per-peer bank at full width: 4 peers
    x batch 32 on CIFAR-shaped data, SGD with momentum, lr 0.01, the first
    step timed apart; params and momentum made by ``peer_bank`` from one
    seeded copy, the async mailbox by ``init_mailbox``. Launches per step
    and leaf: QSGD one quantize, one ``dequant_reduce`` per distinct mix (P
    on a sparse overlay) and, with EF, one dequantize; top-k one bank select
    and one bank scatter (every mix and own image); async and the robust
    protocols none. Prints s/step, peak memory, the losses and the largest
    gap between two rows of the bank after the last step, which must be
    above 0: each peer follows its own trajectory."""
    from repro_torch.core import (AdversarySpec, PeerBank, QSGDConfig, Topology, TrainState,
                                  build_p2p_train_step, init_mailbox, peer_bank)
    from repro_torch.optim import sgd

    topo = Topology(exchange=exchange, graph=graph, qsgd=QSGDConfig(S, BUCKET),
                    topk_frac=TOPK_FRAC, ef=ef, staleness=staleness)
    adv = None if adversary is None else AdversarySpec(**adversary)
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one, loss_fn, batches = cifar_steps(torch, arch, steps)
    opt = sgd(momentum=0.9)
    step = build_p2p_train_step(loss_fn, opt, topo, PEERS, lambda s: 0.01, adversary=adv)
    bank, opt_state = peer_bank(one, opt.init(one), PEERS)
    mailbox = init_mailbox(one, PEERS, staleness=staleness) if exchange == "async" else None
    state = TrainState(bank, opt_state, 0, torch.Generator(device="cuda").manual_seed(0),
                       mailbox=mailbox)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, losses, marks, _ = run_steps(torch, step, state, batches)
    launches = read_counters(mods)

    leaves, mixes = len(one), (1 if graph == "full" else PEERS)
    expect = dict.fromkeys(KERNELS, 0)
    if exchange == "qsgd":
        expect.update(qsgd_quantize=steps * leaves, qsgd_dequant_reduce=steps * mixes * leaves,
                      qsgd_dequantize=steps * leaves if ef else 0)
    elif exchange == "topk":
        expect.update(topk_select_pack=steps * leaves, topk_scatter_accum=steps * leaves)
    tag = f"bank step {arch} {exchange} graph={graph}" + (" + EF" if ef else "") + (
        f" staleness={staleness}" if exchange == "async" else "") + (
        f" {adv.describe()} on peers {adv.attackers(PEERS)}" if adv else "")
    require(launches == expect, f"{tag}: launches {launches} != expected {expect}")
    require(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss {losses}")
    for what, tree in (("params", state.params), ("momentum", state.opt_state)):
        require(isinstance(tree, PeerBank)
                and all(v.shape == (PEERS, *one[k].shape) for k, v in tree.items()),
                f"{tag}: {what} is not a ({PEERS}, ...) bank")
        require(all(bool(torch.isfinite(v).all()) for v in tree.values()), f"{tag}: non-finite {what}")
    spread = max(float((v - v[0]).abs().max()) for v in state.params.values())
    require(spread > 0, f"{tag}: every row of the bank is the same")
    steady = (marks[-1] - marks[0]) / (steps - 1)
    print(
        f"path {tag}: {leaves} leaves, {sum(v.numel() for v in one.values())} params per peer, "
        f"{PEERS} peers x batch 32, setup {t1 - t0:.3f} s, first step {marks[0] - t1:.3f} s, "
        f"then {steady:.4f} s/step over {steps - 1} steps, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses {[round(x, 4) for x in losses]}, "
        f"largest gap between bank rows {spread:.4e}, launches {launches}"
    )
    return launches


def reference_bank_phase(torch):
    """The per-peer step on the card against the same step on the CPU:
    squeezenet1.1 on MNIST-shaped 8x8, 4 peers x batch 8, SGD with momentum,
    lr 0.05, from the same init: ``allgather_mean`` on the ring and
    ``async`` with staleness 2 on the ring over 3 steps (K + 1, so a
    non-zero stale bank is read), ``qsgd(7, 256)`` + EF on the ring for 1
    step with the CPU's uniforms. The CPU runs its trajectory; each card
    step starts from the CPU's state before it, so every step is held on
    its own. Both sides' gradients of each peer are taken at the CPU's
    params before the step: they differ by ``g`` (about 1e-7; far more where
    a ReLU input lies within cuDNN's and oneDNN's rounding noise of 0 and
    the sides take opposite branches). Momentum, the EF residual and the
    mailbox agree within ``g + f`` + 1e-5, params within ``lr (g + f)`` +
    1e-5, with ``f`` the most one QSGD rounding flip moves a decoded
    element (max norm / s); where ``g <= 1e-5`` and no codec runs, at
    most 1e-4 of the coordinates lie beyond 1e-5."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import (PeerBank, QSGDConfig, Topology, TrainState,
                                  build_p2p_train_step, init_mailbox, peer_bank, peer_row)
    from repro_torch.core import compression as C
    from repro_torch.core.simulate import cnn_loss
    from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro_torch.models.cnn import f32_numerics
    from repro_torch.optim import sgd

    lr = 0.05
    ds = make_dataset("mnist", size=128, image_hw=8, channels=1)
    cfg = dataclasses.replace(get_config("squeezenet1.1"), image_size=8, image_channels=1,
                              num_classes=ds.num_classes)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, PEERS * 8)
    raw = [loader.load(BatchKey(0, 0, i)) for i in range(3)]
    cpu_model = models.init_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model = {"cpu": cpu_model.requires_grad_(False),
             "cuda": copy.deepcopy(cpu_model).to("cuda").requires_grad_(False)}
    one = {k: v.clone() for k, v in cpu_model.named_parameters()}
    to = lambda tree, dev: (PeerBank({k: v.to(dev) for k, v in tree.items()}) if isinstance(tree, PeerBank)
                            else None if tree is None else {k: v.to(dev) for k, v in tree.items()})

    def batch(i, dev):
        return {"images": models.images_to_device(raw[i]["images"], dev),
                "labels": torch.from_numpy(raw[i]["labels"].astype(np.int64)).to(dev)}

    def gradient_gap(bank, i):
        # each peer's gradient on both sides at the CPU's params
        grads = {dev: torch.func.grad(lambda p, b, m=model[dev]: cnn_loss(
            m, p, b["images"], b["labels"]), has_aux=True) for dev in ("cpu", "cuda")}
        gap = 0.0
        for r in range(PEERS):
            rows = slice(8 * r, 8 * r + 8)
            row = peer_row(bank, r)
            b = batch(i, "cpu")
            b = {k: v[rows] for k, v in b.items()}
            g_cpu = grads["cpu"](row, b)[0]
            with f32_numerics():
                g_card = grads["cuda"](to(row, "cuda"), {k: v.cuda() for k, v in b.items()})[0]
            gap = max(gap, max(float((g_card[k].cpu() - g_cpu[k]).abs().max()) for k in row))
        return gap

    cases = (
        (Topology(graph="ring"), 3),
        (Topology(exchange="async", graph="ring", staleness=2), 3),
        (Topology(exchange="qsgd", qsgd=QSGDConfig(7, 256), graph="ring", ef=True), 1),
    )
    draw, reduce = C.draw_uniforms, C.dequant_reduce
    for topo, steps in cases:
        opt = sgd(momentum=0.9)
        step = {dev: build_p2p_train_step(lambda p, b, m=model[dev]: cnn_loss(
            m, p, b["images"], b["labels"]), opt, topo, PEERS, lambda s: lr, device=dev)
            for dev in ("cpu", "cuda")}
        bank, mom = peer_bank(one, opt.init(one), PEERS)
        state = TrainState(bank, mom, 0, torch.Generator().manual_seed(0),
                           mailbox=init_mailbox(one, PEERS, staleness=topo.staleness)
                           if topo.exchange == "async" else None)
        tag = f"squeezenet1.1 bank step, 4 peers, {topo.exchange} graph={topo.graph}" + (
            " + EF" if topo.ef else "") + f", {steps} step{'s' * (steps > 1)}, card vs CPU"
        report = []
        for i in range(steps):
            uniforms, flips = [], [0.0]
            cpu_gen = torch.Generator().manual_seed(i + 1)
            C.draw_uniforms = lambda shape, generator: uniforms.append(
                torch.rand(shape, generator=cpu_gen)) or uniforms[-1].to(generator.device)
            C.dequant_reduce = lambda lev, nrm, w, q: (
                flips.append(float(nrm.max()) / q.levels), reduce(lev, nrm, w, q))[1]
            try:
                g = gradient_gap(state.params, i)
                after, m_cpu = step["cpu"](state, batch(i, "cpu"))
                C.dequant_reduce = reduce
                replay = iter(list(uniforms))
                C.draw_uniforms = lambda shape, generator: next(replay).to(generator.device)
                card_state = state.replace(
                    params=to(state.params, "cuda"), opt_state=to(state.opt_state, "cuda"),
                    mailbox=to(state.mailbox, "cuda"), ef=to(state.ef, "cuda"),
                    key=torch.Generator(device="cuda").manual_seed(0))
                card, m_card = step["cuda"](card_state, batch(i, "cuda"))
            finally:
                C.draw_uniforms, C.dequant_reduce = draw, reduce
            f = max(flips)
            require(abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5 * abs(float(m_cpu["loss"])),
                    f"{tag}: step {i} loss {float(m_card['loss'])} vs {float(m_cpu['loss'])}")
            pairs = [("params", card.params, after.params, lr * (g + f)),
                     ("momentum", card.opt_state, after.opt_state, g + f)]
            if after.ef is not None:
                pairs.append(("ef", card.ef, after.ef, g + f))
            if after.mailbox is not None:
                pairs.append(("mailbox", card.mailbox, after.mailbox, g))
            for what, ours, theirs, bound in pairs:
                gaps = torch.cat([(ours[k].cpu() - theirs[k]).abs().reshape(-1) for k in theirs])
                worst, n_far = float(gaps.max()), int((gaps > 1e-5).sum())
                require(worst <= bound + 1e-5,
                        f"{tag}: step {i} {what} gap {worst:.3e} > {bound + 1e-5:.3e}")
                if g <= 1e-5 and not f:
                    require(n_far <= 1e-4 * gaps.numel(),
                            f"{tag}: step {i} {n_far} of {gaps.numel()} {what} beyond 1e-5")
                report.append(f"step {i} {what} {worst:.3e} (bound {bound + 1e-5:.3e}, {n_far} beyond 1e-5)")
            report.append(f"step {i} gradient gap {g:.3e}")
            state = after
        print(f"reference check ({tag}, each card step from the CPU's state): " + "; ".join(report))


def determinism_phase(torch, mods):
    """Under PyTorch's default global flags (cuDNN TF32 allowed,
    non-deterministic algorithms allowed, as ``main`` leaves them): a seeded
    mobilenet-v3-small ``qsgd(127, 2048)`` cluster, 4 peers x batch 32, 2
    batches an epoch, 2 epochs, run twice, gives bit-identical params; a
    vgg11 gradient through the cluster is bit-identical with the global
    cuDNN TF32 flag on and off; and the CNN paths of the slice (the
    cluster's gradient and evaluation on the three CNNs, the per-peer step
    on squeezenet with a sign_flip attacker on the ring) run under
    ``torch.use_deterministic_algorithms(True)``, which raises at any op
    without a deterministic implementation. These runs' launches stay out
    of the kernels line."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.core import (AdversarySpec, LocalP2PCluster, QSGDConfig, Topology,
                                  TrainState, build_p2p_train_step, peer_bank)
    from repro_torch.data import BatchKey, make_dataset
    from repro_torch.optim import sgd

    def cluster(arch, **kw):
        return LocalP2PCluster(get_config(arch), make_dataset("cifar"), num_peers=PEERS,
                               batch_size=32, batches_per_epoch=2, optimizer=sgd(momentum=0.9),
                               lr=0.01, seed=0, **kw)

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32)
    runs = []
    for _ in range(2):
        cl = cluster("mobilenet-v3-small", exchange="qsgd", qsgd=QSGDConfig(S, BUCKET))
        cl.run(2)
        runs.append([{k: v.clone() for k, v in p.params.items()} for p in cl.peers])
    same = all(torch.equal(a[k], b[k]) for a, b in zip(*runs) for k in a)
    require(same, "mobilenet qsgd cluster: two seeded runs differ")
    grads = []
    cl = cluster("vgg11")
    b = cl._to_device(cl.peers[0].loader.load(BatchKey(0, 0, 0)))
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            grads.append(cl._grad(cl.peers[0].params, b)[0])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    require(all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0]),
            "vgg11 gradient differs between the global TF32 flag on and off")

    probe = []
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic workspace
    torch.use_deterministic_algorithms(True)
    try:
        for arch in ("squeezenet1.1", "vgg11", "mobilenet-v3-small"):
            cl = cluster(arch)
            b = cl._to_device(cl.peers[0].loader.load(BatchKey(0, 0, 0)))
            cl._grad(cl.peers[0].params, b)
            cl._eval(cl.peers[0].params, b)
            probe.append(f"{arch} gradient and evaluation")
        one, loss_fn, (batch,) = cifar_steps(torch, "squeezenet1.1", 1)
        step = build_p2p_train_step(loss_fn, sgd(momentum=0.9),
                                    Topology(exchange="trimmed_mean:0.34", graph="ring"),
                                    PEERS, lambda s: 0.01, adversary=AdversarySpec(**ADV_SIGN))
        bank, mom = peer_bank(one, sgd(momentum=0.9).init(one), PEERS)
        step(TrainState(bank, mom, 0, None), batch)
        torch.cuda.synchronize()
        probe.append("squeezenet per-peer step, trimmed mean on the ring, sign_flip attacker")
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    now = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark, torch.backends.cuda.matmul.allow_tf32)
    require(now == flags, f"the global flags changed from {flags} to {now}")
    print(f"determinism check (global cudnn.allow_tf32, deterministic, benchmark, "
          f"matmul.allow_tf32 = {flags}): two seeded mobilenet qsgd clusters, 2 epochs, "
          f"bit-identical params; a vgg11 gradient bit-identical with the global TF32 flag on and "
          f"off; under use_deterministic_algorithms(True) no op refused: {'; '.join(probe)}")


def bank_grad_timing(torch):
    """The per-peer gradients of the device step at full width (4 peers x
    batch 32, CIFAR-shaped), inside ``f32_numerics``: ``torch.func.vmap``
    over a bank of params (what the per-peer step runs: each convolution
    one grouped convolution over the peers), a loop over the peers (one
    convolution each), and ``vmap`` over params held once (the full graph's
    step), each the mean of 5 calls after a warm-up, timed on the host
    clock with the card synchronised; beside them the largest gap between
    the banked and the looped gradients, and the two vmaps again under the
    earlier settings (cuDNN TF32 off, but non-deterministic algorithms
    allowed): what the deterministic algorithms cost."""
    from repro_torch.models.cnn import f32_numerics

    def wall(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    for arch in ("vgg11", "mobilenet-v3-small"):
        one, loss_fn, (batch,) = cifar_steps(torch, arch, 1)
        split = {k: v.reshape(PEERS, 32, *v.shape[1:]) for k, v in batch.items()}
        bank = {k: v.expand(PEERS, *v.shape).clone() for k, v in one.items()}
        grad = torch.func.grad(loss_fn, has_aux=True)
        banked = torch.func.vmap(grad, in_dims=(0, 0))
        shared = torch.func.vmap(grad, in_dims=(None, 0))

        def loop():
            rows = [grad({k: v[r] for k, v in bank.items()}, {k: v[r] for k, v in split.items()})[0]
                    for r in range(PEERS)]
            return {k: torch.stack([g[k] for g in rows]) for k in bank}

        with f32_numerics():
            times = {"vmap over the bank": wall(lambda: banked(bank, split)),
                     "loop over the peers": wall(loop),
                     "vmap, params held once": wall(lambda: shared(one, split))}
            a, c = banked(bank, split)[0], loop()
            torch.backends.cudnn.deterministic = False  # restored as the scope exits
            earlier = {"vmap over the bank": wall(lambda: banked(bank, split)),
                       "vmap, params held once": wall(lambda: shared(one, split))}
        gap = max(float((a[k] - c[k]).abs().max()) for k in a)
        print(f"timing per-peer gradients {arch}, {PEERS} peers x batch 32, deterministic cuDNN: "
              + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
              + f"; banked vs looped gradients max_abs_err={gap:.3e}; non-deterministic "
              f"algorithms allowed: " + ", ".join(f"{k} {v:.4f} s" for k, v in earlier.items()))


def estimator_timing(torch):
    """The robust estimators and the sharded combines alone, on a bank of 4
    peers x vgg11's parameter count (at 32 px) in f32, timed with CUDA
    events beside a byte bound at 3.35 TB/s: the trimmed mean and the
    median sort the bank (read it, write it sorted) and write the estimate;
    Krum's Gram matrix and selection read the bank and write the selected
    row; the ``reduce_scatter`` combine reads the bank and writes one mean
    (its P rows are one tensor); the ``tree:2`` combine reads the bank and
    writes each peer's row."""
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import exchange as X
    from repro_torch.core import robust as R
    from repro_torch.data import make_dataset

    ds = make_dataset("cifar")
    cfg = dataclasses.replace(get_config("vgg11"), image_size=ds.image_hw,
                              image_channels=ds.channels, num_classes=ds.num_classes)
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
    D = sum(p.numel() for p in model.parameters())
    del model
    bank = torch.randn((PEERS, D), generator=torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    grads, ctx, mask = {"w": bank}, X.ExchangeContext(num_peers=PEERS), np.ones(PEERS, bool)
    row = D * 4
    cases = (
        ("trimmed_mean:0.25", lambda: R.masked_trimmed_mean(bank, mask, 0.25), (2 * PEERS + 1) * row),
        ("median", lambda: R.masked_median(bank, mask), (2 * PEERS + 1) * row),
        ("krum gram + select", lambda: R.krum_select(bank, m=1), (PEERS + 1) * row),
        ("reduce_scatter combine", lambda: X.get_exchange("reduce_scatter").combine(grads, ctx),
         (PEERS + 1) * row),
        ("tree:2 combine", lambda: X.get_exchange("tree:2").combine(grads, ctx), 2 * PEERS * row),
    )
    for name, fn, nbytes in cases:
        ms, host_ms = time_ms(torch, fn, iters=10)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"estimator {name} on a ({PEERS}, {D}) f32 bank: {ms:.4f} ms on the card "
              f"({host_ms:.4f} ms host per call), byte bound {bound:.4f} ms at 3.35 TB/s "
              f"({nbytes} B; {bound / ms:.1%} of the bound)")


def kernel_body(name: str):
    """Which body of the flash or the SSD kernel a device kernel's name is,
    or None: flash's "wgmma<D>" (bf16 on the tensor cores) or "f32" (the
    CUDA cores); the flash backward's two bf16 launches "bwd dq wgmma<D>"
    and "bwd dkdv wgmma<D>", or its f32 body's three passes "bwd f32
    stats", "bwd f32 dq" and "bwd f32 dkdv"; the SSD kernel's bf16 passes
    "ssd states", "ssd carry" and "ssd outputs", or its f32 body "ssd
    f32"."""
    if "flash_attention_kernel_wgmma<" in name:
        return "wgmma<" + name.split("flash_attention_kernel_wgmma<", 1)[1].split(">", 1)[0] + ">"
    if "flash_attention_kernel<" in name:
        return "f32"
    found = re.search(r"\bbwd_(dq|dkdv)_wgmma<(\d+)>", name)
    if found:
        return f"bwd {found.group(1)} wgmma<{found.group(2)}>"
    found = re.search(r"\bbwd_(stats|dq|dkdv)_kernel\b", name)
    if found:
        return "bwd f32 " + found.group(1)
    found = re.search(r"\bssd_kernel_(states|carry|outputs)\b", name)
    if found:
        return "ssd " + found.group(1)
    return "ssd f32" if "ssd_kernel<" in name else None


RUN_MARK = "profiled run"  # the record_function around the run that device_profile reads


def device_profile(torch, fn, attempts: int = 3):
    """Run ``fn`` under ``torch.profiler`` and read the device's kernels:
    (device window ms from the first kernel's start to the last one's end,
    busy ms in that window, {"ssd_scan" | "flash_attention" |
    "flash_attention_backward" | "matmul" | "other": kernel ms} (every pass
    of the SSD kernel's bf16 body counts as ssd_scan, every pass of the flash
    backward as flash_attention_backward), the 5 kernels with the most device time, the number of
    device activities, {flash or SSD body: [launches, ms]}, (the run's
    kernel launches that the profiler recorded on the host with no device
    record, the run's kernel launches)); None when the profiler saw no
    device activity.

    On the card the profiler can lose the device records of the first
    kernels launched in a session while it keeps the host's records of the
    launches (seen after ``torch.compile`` has run in the process). So each
    session runs ``fn`` twice: a first run, not read, then a spin kernel
    waited for, then the run that is read: the device activities that start
    after the spin kernel ends. A session that still lost a record of that
    run is taken again, up to ``attempts`` in all, and the last one is read
    whatever it lost."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = torch.autograd.DeviceType.CUDA
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with record_function(RUN_MARK):
                fn()
                torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        marks = [e.end_ns() for e in events if e.device_type() == device and "spin_kernel" in e.name()]
        run = [e for e in events if e.device_type() != device and e.name() == RUN_MARK]
        require(len(run) == 1, f"profile: {len(run)} host records of the run, not 1")
        launches = [e for e in events if e.device_type() != device
                    and run[0].start_ns() <= e.start_ns() <= run[0].end_ns()
                    and re.search(r"[Ll]aunch(Cooperative)?Kernel", e.name())]
        matched = set()
        for e in events:
            if e.device_type() == device:
                matched.update((e.correlation_id(), e.linked_correlation_id()))
        lost = sum(e.correlation_id() not in matched for e in launches)
        if marks and not lost:
            break
        print(f"profile attempt {attempt} of {attempts}: the profiler lost the device records of "
              f"{lost} of the run's {len(launches)} kernel launches"
              + ("" if marks else " and of the spin kernel before it"))
    require(len(marks) == 1, f"profile: {len(marks)} device records of the spin kernel, not 1")
    kernels = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events
               if e.device_type() == device and e.start_ns() >= marks[0] and e.name() != RUN_MARK]
    if not kernels:
        return None
    spans = sorted((start, end) for _, start, end in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    groups, by_name, bodies = {}, {}, {}
    for name, start, end in kernels:
        us = end - start
        low = name.lower()
        body = kernel_body(name)
        if body:
            count, ms = bodies.get(body, (0, 0.0))
            bodies[body] = [count + 1, ms + us / 1e3]
        key = "ssd_scan" if "ssd_kernel" in name else "flash_attention" if (
            "flash_attention_kernel" in name) else "flash_attention_backward" if (
            body or "").startswith("bwd ") else "topk_select" if re.search(
            r"\bselect_(row_|grid_)?kernel", name) else "topk_scatter" if re.search(
            r"\bscatter_(tile_|bucket_|gather_)?kernel", name) else (
            "matmul" if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")) else "other")
        groups[key] = groups.get(key, 0.0) + us / 1e3
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return ((spans[-1][1] - spans[0][0]) / 1e3, busy / 1e3, groups, top, len(kernels), bodies,
            (lost, len(launches)))


def print_profile(what: str, prof, bodies_expected: dict) -> None:
    """Print a ``device_profile``; fail unless its flash and SSD launches by
    body are exactly ``bodies_expected`` ({body: launches})."""
    if prof is None:
        print(f"profile {what}: the profiler recorded no device kernels; busy share not measured")
        return
    window, busy, groups, top, count, bodies, (lost, launched) = prof
    seen = {body: n for body, (n, _) in bodies.items()}
    require(seen == bodies_expected,
            f"profile {what}: flash and SSD launches by body {seen} != {bodies_expected} "
            f"(the profiler lost the device records of {lost} of {launched} kernel launches)")
    print(f"profile {what}: {count} device activities (kernels and copies) for {launched} kernel "
          f"launches ({lost} device records lost), device window "
          f"{window:.3f} ms, kernels busy {busy:.3f} ms "
          f"(idle share {1 - busy / window:.1%}); by kind "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(groups.items()))
          + "; flash and SSD bodies " + (", ".join(f"{b} {n} launches {ms:.3f} ms" for b, (n, ms)
                                           in sorted(bodies.items())) or "none")
          + "; top kernels " + "; ".join(f"{n[:60]} {v:.3f} ms" for n, v in top))


def init_lm(torch, arch, cut: str = ""):
    """``arch`` (a name, or a config) at full width, its weights random
    from a seeded generator, on the card; ``cut`` says how its depth was
    cut, if it was."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(arch) if isinstance(arch, str) else arch
    t0 = time.perf_counter()
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)
    torch.cuda.synchronize()
    print(f"path {cfg.name}: {models.param_count(model)} params{cut}, init "
          f"{time.perf_counter() - t0:.3f} s")
    return model, cfg


def drive_scoring(torch, mods, model, cfg, tokens, flags: dict, expect: dict, extra=None):
    """The scoring forward with ``flags``: a warm-up and 3 timed calls,
    each launching exactly ``expect``; ``extra``: the batch's other entries
    (whisper's frames, the VLM's patches). Returns the launches of all
    four."""
    from repro_torch import models

    total = dict.fromkeys(KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(4):
        reset_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, aux = models.forward(model, {"tokens": tokens, **(extra or {})}, cfg, **flags)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        require(math.isfinite(float(aux)) and (float(aux) > 0) == bool(cfg.num_experts),
                f"{cfg.name} scoring aux {float(aux)}")
        launches = read_counters(mods)
        require(launches == expect, f"{cfg.name} scoring forward {i}: launches {launches} != {expect}")
        for name, count in launches.items():
            total[name] += count
    require(logits.shape == (*tokens.shape, cfg.vocab_size) and logits.dtype == torch.float32,
            f"{cfg.name} scoring logits {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), f"{cfg.name} scoring logits not finite")
    if cfg.final_logit_softcap:
        require(float(logits.abs().max()) <= cfg.final_logit_softcap,
                f"{cfg.name} logits beyond the final softcap")
    steady = sum(secs[1:]) / 3
    extra_shapes = "".join(f" + {k} {tuple(v.shape)}" for k, v in (extra or {}).items())
    print(f"path {cfg.name} scoring, {tokens.shape[0]} x {tokens.shape[1]} tokens{extra_shapes}, "
          f"{flags or 'flash kernel'}: "
          f"warm-up {secs[0]:.3f} s, then {steady:.4f} s/forward ({[round(x, 4) for x in secs[1:]]}), "
          f"{tokens.numel() / steady:.0f} tokens/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches per forward "
          f"{ {k: v for k, v in expect.items() if v} }")
    return total


def generate_with(torch, model, cfg, prompts, extra: dict, gen: int, cache_len: int):
    """The serve twin's ``generate`` for a batch that carries more than
    tokens (whisper's frames, the VLM's patches), which the twin's CLI does
    not build: prefill of ``prompts`` with ``extra`` into a decode state of
    ``cache_len`` positions, then ``gen`` greedy tokens, timed likewise."""
    from repro_torch import models

    with torch.inference_mode():
        state = models.init_decode_state(cfg, prompts.shape[0], cache_len,
                                         device=next(model.parameters()).device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = models.prefill(model, state, {"tokens": prompts, **extra}, cfg)
        out = [logits.argmax(-1)[:, None]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            step_logits, state = models.decode_step(model, state, out[-1], cfg)
            out.append(step_logits.argmax(-1)[:, None])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(), "prefill_logits": logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def drive_serve(torch, mods, model, cfg, prompts, gen: int, expect: dict, what: str,
                extra=None, cache_len=None):
    """The serve twin's ``generate``: prefill of ``prompts`` (through the
    flash kernel), then ``gen`` greedy tokens, launching exactly
    ``expect``; with ``extra`` (frames or patches) ``generate_with`` into
    ``cache_len`` positions. Returns (launches, the generation's result)."""
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    reset_counters(mods)
    res = (generate_with(torch, model, cfg, prompts, extra, gen, cache_len) if extra
           else serve.generate(model, cfg, prompts, gen))
    launches = read_counters(mods)
    require(launches == expect, f"{cfg.name} serve {what}: launches {launches} != {expect}")
    B, P = prompts.shape
    require(res["tokens"].shape == (B, gen) and bool((res["tokens"] >= 0).all())
            and bool((res["tokens"] < cfg.vocab_size).all()), f"{cfg.name} serve tokens {res['tokens'].shape}")
    require(bool(torch.isfinite(res["prefill_logits"]).all()), f"{cfg.name} prefill logits not finite")
    if gen > 2:
        per_token = res["decode_s"] / (gen - 1)
        print(f"path {cfg.name} serve, {what}, prompt {P}, {gen} greedy tokens: prefill "
              f"{res['prefill_s']:.4f} s, decode {per_token * 1e3:.2f} ms/token ({B / per_token:.1f} "
              f"tok/s), {B * (P + gen) / (res['prefill_s'] + res['decode_s']):.1f} tok/s incl. prefill, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
              f"{ {k: v for k, v in launches.items() if v} }; request 0: {res['tokens'][0][:16].tolist()}")
    return launches, res


def check_prefill_vs_forward(torch, mods, model, cfg, prompts, prefill_logits, flags, expect,
                             extra=None):
    """Prefill's last logits against the scoring forward's last position on
    the same prompts (and ``extra``, the frames or patches the prefill
    had), within twice that forward's own bf16 error (its distance from the
    same forward in f32). The two forwards must launch 2 x ``expect``, the
    causal conv's kernels once (they take bf16 alone: the f32 forward runs
    the plain conv); a check, so kept out of the kernels line."""
    import dataclasses

    from repro_torch import models

    reset_counters(mods)
    with torch.inference_mode():
        batch = {"tokens": prompts, **(extra or {})}
        full, _ = models.forward(model, batch, cfg, **flags)
        full32, _ = models.forward(model, batch, dataclasses.replace(cfg, dtype="float32"), **flags)
    launches = read_counters(mods)
    twice = {k: (1 if k == "causal_conv_silu" else 2) * v for k, v in expect.items()}
    require(launches == twice, f"{cfg.name} prefill check's two forwards: launches {launches} != {twice}")
    last, last32 = full[:, -1], full32[:, -1]
    budget = 2 * float((last - last32).abs().max())
    gap = float((prefill_logits - last).abs().max())
    require(gap <= budget, f"{cfg.name} prefill's last logits {gap:.3e} from the forward's last position, "
            f"beyond twice the forward's bf16 error ({budget:.3e})")
    print(f"path {cfg.name} prefill vs scoring forward, last position of the {prompts.shape[1]}-token "
          f"prompts: max_abs_err={gap:.3e} (tolerance {budget:.3e}: twice the bf16 forward's distance "
          f"from the f32 forward; max|logits| {float(last32.abs().max()):.3f})")


@contextlib.contextmanager
def recording(module, attr: str, want=lambda args, kw: True):
    """Replace ``module.attr`` by a pass-through that keeps the arguments of
    its first call that ``want`` accepts; yields the list they go into."""
    fn, seen = getattr(module, attr), []

    def record(*args, **kw):
        if not seen and want(args, kw):
            seen.append((args, kw))
        return fn(*args, **kw)

    setattr(module, attr, record)
    try:
        yield seen
    finally:
        setattr(module, attr, fn)


def drive_lm(torch, mods):
    """mamba2-370m at full width (48 layers, d_model 1024, vocab 50,280),
    bf16 as configured, f32 matmuls without TF32. (a) Scoring:
    ``forward(..., use_ssd_kernel=True)`` on 4 x 2048 tokens, 48 SSD
    launches each. (b) The serve twin: prefill of 4 x 512 tokens and 32
    greedy tokens (a short warm-up first), no SSD launch (prefill takes the
    plain chunked scan, as in the reference). The kernels line counts (a)
    and (b). Then two checks, their launches required and left out of that
    line: the kernel on one layer's own inputs (``check_ssd_on_path``) and
    ``check_prefill_vs_forward``."""
    model, cfg = init_lm(torch, "mamba2-370m")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=g, device="cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), ssd_scan=cfg.num_layers,
                  causal_conv_silu=cfg.num_layers if takes_conv(cfg) else 0)
    total = drive_scoring(torch, mods, model, cfg, tokens, SSD_FLAGS, expect)
    dryrun_scoring(torch, mods, model, cfg, tokens, SSD_FLAGS, expect)
    prompts = tokens[:, :PROMPT].contiguous()
    for gen, what in ((2, "warm-up"), (GEN, "batch 4")):
        _, res = drive_serve(torch, mods, model, cfg, prompts, gen, dict.fromkeys(KERNELS, 0), what)
    err = check_ssd_on_path(torch, mods, model, cfg, tokens, expect)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"],
                             SSD_FLAGS, expect)
    return total, err, (model, cfg, tokens, prompts)


def ssd_exact(torch, x, dt, A, Bm, Cm):
    """The SSD scan's function step by step in f64, y (B, S, H, P): h_t =
    exp(dt_t A) h_(t-1) + dt_t x_t B_t^T, y_t = h_t C_t, each group's B and
    C shared by its heads."""
    f64 = torch.float64
    rep = x.shape[2] // Bm.shape[2]
    Bh, Ch = (t.to(f64).repeat_interleave(rep, dim=2) for t in (Bm, Cm))
    h = torch.zeros((*x.shape[:1], *x.shape[2:], Bm.shape[-1]), dtype=f64, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t].to(f64)  # (B, H)
        h = h * torch.exp(dt_t * A.to(f64))[..., None, None] \
            + (dt_t[..., None] * x[:, t].to(f64))[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1)


@contextlib.contextmanager
def kernel_order_cum(torch, ks):
    """Within the block, ``ks.ssd_chunked`` (the plain version) sums each
    chunk's inclusive cumsum of the log-decays as the bf16 body's
    ``chunk_cum`` does (csrc/ssd_scan.cu): a shuffle scan within each warp
    of 32 rows, then the sums of the warps before, added in order from 0.
    f32 addition gives the same bits in the same order, so the plain
    version then sees the kernel's cum."""
    def cumsum(a, dim):
        require(dim == 2 and a.shape[2] % 32 == 0, f"cumsum over dim {dim} of {tuple(a.shape)}")
        v = a.reshape(*a.shape[:2], a.shape[2] // 32, 32, *a.shape[3:])
        for off in (1, 2, 4, 8, 16):
            v = v + torch.cat([torch.zeros_like(v[:, :, :, :off]), v[:, :, :, :-off]], dim=3)
        before, run = [], torch.zeros_like(v[:, :, 0, 31])
        for w in range(v.shape[2]):
            before.append(run)
            run = run + v[:, :, w, 31]
        return (v + torch.stack(before, dim=2)[:, :, :, None]).reshape(a.shape)

    class Ordered:
        def __getattr__(self, name):
            return getattr(torch, name)

    ordered = Ordered()
    ordered.cumsum = cumsum
    ks.torch = ordered
    try:
        yield
    finally:
        ks.torch = torch


def check_ssd_on_path(torch, mods, model, cfg, tokens, expect, cancels: bool = False):
    """The SSD kernel on the inputs the main path gives it: one more scoring
    forward on the same tokens (its launches required and kept out of the
    kernels line) hands its first layer's x, dt, A, B and C, strided views
    of the convolution's output, to a recorder; the kernel is then held to
    its plain version on those same views within 2e-5 of max|y|, as at the
    scoring shape in the kernel phase (mamba2-370m). ``cancels``
    (zamba2-1.2b, whose layer-0 output is half the size of the terms that
    sum to it): within 2e-5 of the largest sum of the terms' sizes (the
    same scan of |x|, |B| and |C|) in place of max|y|, from the plain
    version and from the scan computed step by step in f64
    (``ssd_exact``), whose distance from the plain version is printed
    beside it. Its log-decays reach -62 a step, so a chunk's inclusive
    cumsum reaches -3600, where one f32 ulp is 2.4e-4: the decays
    exp(cum_i - cum_j) carry the rounding of the cumsum, which the kernel
    and ``torch.cumsum`` sum in other orders. So the kernel is also held to
    mamba2's rule, 2e-5 of max|y|, against the plain version run on the
    cumsum summed in the bf16 body's order (``kernel_order_cum``), whose
    distance from the f64 scan is printed beside the kernel's f32 body's."""
    from repro_torch import models
    from repro_torch.models import ssm

    reset_counters(mods)
    with recording(ssm, "ssd_scan") as seen, torch.inference_mode():
        models.forward(model, {"tokens": tokens}, cfg, use_ssd_kernel=True)
    launches = read_counters(mods)
    require(launches == expect, f"recording forward: launches {launches} != {expect}")
    args, kw = seen[0]
    plain = mods["ks"].ssd_scan_plain
    with torch.inference_mode():
        y = ssm.ssd_scan(*args, **kw)
        ref = plain(*args, **kw)
    torch.cuda.synchronize()
    x, dt, A, Bm, Cm = args
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    require(x.dtype == torch.bfloat16 and not x.is_contiguous() and not Bm.is_contiguous(),
            f"the path's SSD inputs: {x.dtype}, x strides {x.stride()}, B strides {Bm.stride()}")
    what = (f"kernel check ssd_scan on layer 0's inputs of {cfg.name}'s scoring forward "
            f"{tuple(x.shape)} bf16 (x strides {x.stride()}, dt {dt.stride()}, B/C {Bm.stride()}): "
            f"max_abs_err={err:.3e}, relative to max|y| {err / scale:.3e} (max|y| {scale:.3f}")
    if cancels:
        ks = mods["ks"]
        with torch.inference_mode():
            sizes = float(plain(x.abs(), dt, A, Bm.abs(), Cm.abs(), **kw).max())
            y64 = ssd_exact(torch, *args)
            y32 = ks.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float(), **kw)
            with kernel_order_cum(torch, ks):
                ordered = plain(*args, **kw)
        torch.cuda.synchronize()
        off64 = lambda t: float((t - y64).abs().max())
        kern, ref64 = off64(y), off64(ref)
        require(max(err, kern) <= 2e-5 * sizes, f"ssd_scan on {cfg.name}'s path inputs: "
                f"{err:.3e} from the plain version, {kern:.3e} from the scan in f64, beyond 2e-5 "
                f"x the largest sum of the terms' sizes ({sizes:.3e})")
        same_cum = float((ordered - y).abs().max())
        require(same_cum <= 2e-5 * scale, f"ssd_scan on {cfg.name}'s path inputs: {same_cum:.3e} "
                f"from the plain version on the kernel's cumsum, beyond 2e-5 x max|y| ({scale:.3e})")
        a = (dt * A).float()
        cum = a.reshape(a.shape[0], -1, kw["chunk"], a.shape[-1]).cumsum(2)
        print(what + f"; {err / (2e-5 * scale):.3f} of 2e-5 max|y|): {err / (2e-5 * sizes):.3f} of "
              f"2e-5 x the largest sum of the terms' sizes ({sizes:.3f}); from the scan in f64 "
              f"kernel {kern:.3e} ({kern / (2e-5 * sizes):.3f} of that limit), its f32 body "
              f"{off64(y32):.3e}, plain version {ref64:.3e}; log-decays down to {float(a.min()):.2f} "
              f"a step, a chunk's cumsum down to {float(cum.min()):.2f}; the plain version on the "
              f"cumsum in the bf16 body's order: {same_cum:.3e} from the kernel ({same_cum / (2e-5 * scale):.3f} "
              f"of 2e-5 max|y|), {off64(ordered):.3e} from the scan in f64")
        return err
    require(err <= 2e-5 * scale, f"ssd_scan on the path's inputs: max abs error {err:.3e} > 2e-5 * "
            f"max|y| ({scale:.3e})")
    print(what + "; max abs <= 2e-5 max|y|)")
    return err


def drive_gemma(torch, mods):
    """gemma2-2b at full width (26 layers alternating local and global
    attention, d_model 2304, 8 heads over 4 KV heads of 256, vocab
    256,000), bf16 as configured, f32 matmuls without TF32. (a) Scoring:
    ``forward`` on 1 x 8192 tokens, its full
    context, where the local layers' 4096 window bites: 26 flash launches
    each. (b) The serve twin: batch 4, a 512-token prompt and 32 greedy
    tokens (a short warm-up first), and batch 1, a 6144-token prompt and 16
    tokens, so that the local layers' 4096-token caches roll: 26 flash
    launches in each prefill, none in decode. The kernels line counts (a)
    and (b), warm-ups included: 4 x 26 + 3 x 26. Then two checks, their
    launches required and kept out of that line: the kernel on one layer's
    own q, k and v (``check_flash_on_path``) and ``check_prefill_vs_forward``."""
    model, cfg = init_lm(torch, "gemma2-2b")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, FLASH_SCORING[1]), generator=g, device="cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), flash_attention=cfg.num_layers)
    total = drive_scoring(torch, mods, model, cfg, tokens, {}, expect)
    prompts = torch.randint(0, cfg.vocab_size, (4, PROMPT), generator=g, device="cuda")
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT), generator=g, device="cuda")
    served = {}
    for what, prompt, gen in (("warm-up", prompts, 2), ("batch 4", prompts, GEN),
                              ("batch 1 long", long_prompt, LONG_GEN)):
        launches, served[what] = drive_serve(torch, mods, model, cfg, prompt, gen, expect, what)
        for name, count in launches.items():
            total[name] += count
    err = check_flash_on_path(torch, mods, model, cfg, tokens, expect)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, served["batch 4"]["prefill_logits"],
                             {}, expect)
    return total, err, (model, cfg, tokens, prompts)


def check_flash_on_path(torch, mods, model, cfg, tokens, expect, flags=None, extra=None,
                        layers=None):
    """The flash kernel on the inputs the main path gives it: one more
    scoring forward with ``flags`` on the same tokens (and ``extra``, the
    frames or patches; its launches required and kept out of the kernels
    line) hands to recorders the q, k and v of the first call each of
    ``layers`` accepts: {name: (a test of the wrapper's (args, kwargs), the
    (Sq, Skv) it must have)}, by default the first local layer (gemma2-2b's
    window 4096; required where the config has a sliding window) and the
    first global layer of a decoder-only LM. Every layer named must be
    seen; the kernel is then held to its plain version on each within
    ``flash_tolerance``, and the planted faults' distances are printed
    beside it."""
    from repro_torch import models
    from repro_torch.models import layers as model_layers

    S_ = tokens.shape[1] + cfg.vision_tokens * ("patches" in (extra or {}))
    if layers is None:
        layers = {"the first global layer": (lambda args, kw: kw["window"] == 0, (S_, S_))}
        if cfg.sliding_window:
            layers["the first local layer"] = (lambda args, kw: kw["window"] != 0, (S_, S_))
    reset_counters(mods)
    with contextlib.ExitStack() as stack:
        seen = {name: stack.enter_context(recording(model_layers, "flash_attention", want))
                for name, (want, _) in layers.items()}
        stack.enter_context(torch.inference_mode())
        models.forward(model, {"tokens": tokens, **(extra or {})}, cfg, **(flags or {}))
    launches = read_counters(mods)
    require(launches == expect, f"{cfg.name} recording forward: launches {launches} != {expect}")
    require(all(seen.values()), f"{cfg.name} recording forward: layers seen "
            f"{ {name: len(calls) for name, calls in seen.items()} }")
    worst = 0.0
    for name, (_, (Sq, Skv)) in layers.items():
        (q, k, v), kw = seen[name][0]
        require(q.dtype == torch.bfloat16
                and q.shape == (tokens.shape[0], Sq, cfg.num_heads, cfg.resolved_head_dim)
                and k.shape[1] == Skv, f"the path's flash inputs at {name}: {q.dtype} "
                f"q {tuple(q.shape)} k {tuple(k.shape)}")
        with torch.inference_mode():
            worst = max(worst, check_flash(
                torch, mods["kf"], q, k, v, f"on {name}'s q, k, v of {cfg.name}'s scoring "
                f"forward {tuple(q.shape)} Skv={k.shape[1]} K={k.shape[2]} {kw}", faults="report",
                **kw))
    return worst


def drive_zamba(torch, mods):
    """zamba2-1.2b at full width (38 layers: 32 Mamba-2 layers, d_inner
    4096 = 64 SSD heads of 64, N 64, and 6 applying the one weight-tied
    attention + MLP block, 32 heads of 64 over 32; d_model 2048, vocab
    32,000), bf16. (a) Scoring: ``forward(..., use_ssd_kernel=True)`` on 4
    x 2048 tokens, 32 SSD launches (each the bf16 body's three passes) and
    6 flash launches each. (b) The serve twin: prefill of 4 x 512 tokens
    (6 flash launches, the Mamba-2 layers through ``ssd_chunked``) and 32
    greedy tokens (none in decode), a short warm-up first. The kernels line
    counts (a) and (b). Then the checks, their launches required and left
    out of that line: the SSD kernel on layer 0's inputs
    (``check_ssd_on_path``), the flash kernel on the first shared layer's
    (``check_flash_on_path``) and ``check_prefill_vs_forward``. Returns
    (launches, SSD error, flash error, what the profile phase reuses)."""
    model, cfg = init_lm(torch, "zamba2-1.2b")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, SCORING_BATCH, generator=g, device="cuda")
    shared = sum(s.mixer == "shared_attn" for s in cfg.block_specs())
    expect = dict(dict.fromkeys(KERNELS, 0), ssd_scan=cfg.num_layers - shared,
                  flash_attention=shared,
                  causal_conv_silu=cfg.num_layers - shared if takes_conv(cfg) else 0)
    total = drive_scoring(torch, mods, model, cfg, tokens, SSD_FLAGS, expect)
    dryrun_scoring(torch, mods, model, cfg, tokens, SSD_FLAGS, expect)
    prompts = tokens[:, :PROMPT].contiguous()
    prefill = dict(dict.fromkeys(KERNELS, 0), flash_attention=shared)
    for gen, what in ((2, "warm-up"), (GEN, "batch 4")):
        launches, res = drive_serve(torch, mods, model, cfg, prompts, gen, prefill, what)
        for name, count in launches.items():
            total[name] += count
    ssd_err = check_ssd_on_path(torch, mods, model, cfg, tokens, expect, cancels=True)
    flash_err = check_flash_on_path(torch, mods, model, cfg, tokens, expect, SSD_FLAGS)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"], SSD_FLAGS,
                             expect)
    return total, ssd_err, flash_err, (model, cfg, tokens, prompts)


def drive_granite(torch, mods):
    """granite-moe-3b-a800m at full width (32 layers, d_model 1536, 24
    heads of 64 over 8 KV heads, 40 experts of width 512, top 8, vocab
    49,155), bf16. (a) Scoring: ``forward`` on 4 x 2048 tokens with the
    dense dispatch (two chunks of 4096 tokens, every expert on every token)
    and with the capacity dispatch (each expert's 2048 slots), 32 flash
    launches each. (b) The serve twin (the dense dispatch, as the
    reference's): prefill of 4 x 512 and 32 greedy tokens, a short warm-up
    first, 32 flash launches in each prefill, none in decode. The kernels
    line counts (a) and (b). Then the flash kernel on the first layer's
    q, k and v (``check_flash_on_path``) and ``check_prefill_vs_forward``,
    their launches kept out of that line. Returns (launches, flash
    error)."""
    model, cfg = init_lm(torch, "granite-moe-3b-a800m")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, SCORING_BATCH, generator=g, device="cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), flash_attention=cfg.num_layers)
    total = dict.fromkeys(KERNELS, 0)
    for dispatch in ("dense", "capacity"):
        for name, count in drive_scoring(torch, mods, model, cfg, tokens,
                                         {"moe_dispatch": dispatch}, expect).items():
            total[name] += count
    prompts = tokens[:, :PROMPT].contiguous()
    for gen, what in ((2, "warm-up"), (GEN, "batch 4")):
        launches, res = drive_serve(torch, mods, model, cfg, prompts, gen, expect, what)
        for name, count in launches.items():
            total[name] += count
    dense = {"moe_dispatch": "dense"}
    err = check_flash_on_path(torch, mods, model, cfg, tokens, expect, dense)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"], dense, expect)
    del model
    release(torch)
    return total, err


def depth_that_fits(torch, cfg) -> tuple:
    """The depth of ``cfg`` cut to what fits the card at published widths
    (moonshot-v1-16b-a3b's 48 layers hold 28.9 B f32 params, 107.6 GiB;
    internvl2-26b's 19.9 B, 74.1 GiB). Reckoned from the params of one
    layer and of the rest (embedding, unembedding, final norm, the VLM's
    projector) in f32, with 16 GiB kept for the scoring forward (a layer's
    bf16 weights, moonshot's every expert's activations over its 2048
    tokens, the f32 logits) and the allocator. Returns (layers, the
    reckoning as text)."""
    import dataclasses

    from repro_torch import models

    count = lambda n: models.param_count(models.init_model(
        dataclasses.replace(cfg, num_layers=n), generator=None, device="meta"))
    per_layer, rest = count(2) - count(1), 2 * count(1) - count(2)
    card = torch.cuda.get_device_properties(0).total_memory
    layers = min(cfg.num_layers, int((card - 16 * 2**30 - 4 * rest) // (4 * per_layer)))
    return layers, (f"{per_layer} params a layer ({4 * per_layer / 2**30:.2f} GiB in f32), {rest} "
                    f"outside the layers ({4 * rest / 2**30:.2f} GiB), the card's "
                    f"{card / 2**30:.2f} GiB less 16 GiB for the forward")


def drive_moonshot(torch, mods):
    """moonshot-v1-16b-a3b at published widths (d_model 2048, 16 heads of
    128, MHA, 64 experts of width 1408, top 6, the always-on shared expert
    of width 2816, vocab 163,840), bf16, its depth CUT to
    ``depth_that_fits`` layers (the cut printed): scoring ``forward`` on 1 x
    2048 tokens with the dense dispatch, one flash launch a layer, counted
    in the kernels line; then the flash kernel on the first layer's q, k
    and v (``check_flash_on_path``, kept out of it). Returns (launches,
    flash error)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("moonshot-v1-16b-a3b")
    layers, why = depth_that_fits(torch, full)
    require(layers >= 1, f"moonshot: no layer fits ({why})")
    cfg = dataclasses.replace(full, num_layers=layers)
    print(f"path {full.name}: depth CUT from {full.num_layers} to {layers} layers, widths as "
          f"published ({why})")
    model, cfg = init_lm(torch, cfg, f" ({layers} of {full.num_layers} layers)")
    tokens = torch.randint(0, cfg.vocab_size, (1, MOONSHOT_SEQ),
                           generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), flash_attention=layers)
    dense = {"moe_dispatch": "dense"}
    total = drive_scoring(torch, mods, model, cfg, tokens, dense, expect)
    err = check_flash_on_path(torch, mods, model, cfg, tokens, expect, dense)
    del model
    release(torch)
    return total, err


def whisper_layers(cfg, text: int) -> dict:
    """``check_flash_on_path``'s layers of whisper's scoring forward: its
    first encoder layer (non-causal, frames x frames), first decoder
    self-attention (causal, ``text`` x ``text``) and first cross attention
    (non-causal, ``text`` queries over the frames)."""
    E = cfg.encoder_seq
    square = lambda args: args[0].shape[1] == args[1].shape[1]
    return {"the first encoder layer": (lambda a, kw: not kw["causal"] and square(a), (E, E)),
            "the first decoder self-attention": (lambda a, kw: kw["causal"], (text, text)),
            "the first cross attention": (lambda a, kw: not kw["causal"] and not square(a),
                                          (text, E))}


def drive_whisper(torch, mods):
    """whisper-base at full width and depth (6 encoder and 6 decoder layers,
    d_model 512, 8 heads of 64, vocab 51,865, 1500 frames), bf16, its
    frames seeded f32 normals (B, 1500, 512) standing for the stubbed conv
    frontend. (a) Scoring: ``forward`` on 16 x (1500 frames, 448 tokens,
    Whisper's text context), 18 flash launches each: 6 in the encoder
    (non-causal, 1500 x 1500), 6 in the decoder's self-attention (causal)
    and 6 in its cross attention (non-causal, 448 queries over 1500 keys).
    (b) Serving: prefill of 16 x 4 prompt tokens (Whisper's
    start-of-transcript prefix) with their frames, 18 flash launches (the
    encoder once, every layer's cross K/V written into the state), then 64
    greedy tokens, none (decode attends through ``attend``), a short
    warm-up first. The kernels line counts (a) and (b). Then the flash
    kernel on the first encoder, decoder self- and cross attention's own
    q, k and v (``check_flash_on_path``) and ``check_prefill_vs_forward``,
    their launches kept out of that line. Returns (launches, flash
    error)."""
    model, cfg = init_lm(torch, "whisper-base")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (WHISPER_ROWS, WHISPER_TEXT), generator=g,
                           device="cuda")
    frames = stub_inputs(torch, cfg, WHISPER_ROWS, g, "cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), flash_attention=cfg.encoder_layers + 2 * cfg.num_layers)
    total = drive_scoring(torch, mods, model, cfg, tokens, {}, expect, frames)
    prompts = tokens[:, :WHISPER_PROMPT].contiguous()
    for gen, what in ((2, "warm-up"),
                      (WHISPER_GEN, f"batch {WHISPER_ROWS} with {cfg.encoder_seq} frames each")):
        launches, res = drive_serve(torch, mods, model, cfg, prompts, gen, expect, what, frames,
                                    WHISPER_PROMPT + gen)
        for name, count in launches.items():
            total[name] += count
    err = check_flash_on_path(torch, mods, model, cfg, tokens, expect, extra=frames,
                              layers=whisper_layers(cfg, WHISPER_TEXT))
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"], {}, expect,
                             frames)
    del model
    release(torch)
    return total, err


def drive_internvl2(torch, mods):
    """internvl2-26b at published widths (d_model 6144, 48 heads of 128
    over 8 KV heads: GQA groups of 6, d_ff 16,384, vocab 92,553, 256 vision
    tokens), bf16, its depth CUT to ``depth_that_fits`` layers (the
    reckoning printed before the model is built), its patches seeded f32
    normals (B, 256, 6144) standing for the stubbed vision encoder. (a)
    Scoring: ``forward`` on 1 x (256 patches + 2048 tokens), a flash launch
    a layer over the 2304 positions. (b) Serving: prefill of 1 x (256 +
    512), a flash launch a layer, then 16 greedy tokens, none, a short
    warm-up first. The kernels line counts (a) and (b). Then the flash
    kernel on the first layer's own q, k and v (``check_flash_on_path``)
    and ``check_prefill_vs_forward``, their launches kept out of it.
    Returns (launches, flash error)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("internvl2-26b")
    layers, why = depth_that_fits(torch, full)
    require(layers >= 1, f"internvl2: no layer fits ({why})")
    print(f"path {full.name}: depth CUT from {full.num_layers} to {layers} layers, widths as "
          f"published ({why})")
    model, cfg = init_lm(torch, dataclasses.replace(full, num_layers=layers),
                         f" ({layers} of {full.num_layers} layers)")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, VLM_TEXT), generator=g, device="cuda")
    patches = stub_inputs(torch, cfg, 1, g, "cuda")
    expect = dict(dict.fromkeys(KERNELS, 0), flash_attention=layers)
    total = drive_scoring(torch, mods, model, cfg, tokens, {}, expect, patches)
    prompts = tokens[:, :VLM_PROMPT].contiguous()
    for gen, what in ((2, "warm-up"), (VLM_GEN, f"batch 1 after {cfg.vision_tokens} patches")):
        launches, res = drive_serve(torch, mods, model, cfg, prompts, gen, expect, what, patches,
                                    cfg.vision_tokens + VLM_PROMPT + gen)
        for name, count in launches.items():
            total[name] += count
    err = check_flash_on_path(torch, mods, model, cfg, tokens, expect, extra=patches)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"], {}, expect,
                             patches)
    del model
    release(torch)
    return total, err

DRYRUN_ROWS = []  # the dryrun phase's reckoned-against-measured rows, one per path
DRYRUN_PEAK_TOL = 0.05  # the meta peak against the card's max_memory_allocated, relative


def dryrun_check(torch, what: str, card, meta, held: int, peak: int, secs: float,
                 model_flops: float) -> None:
    """Hold the dry run's reckoning of one path (``meta``: its count on the
    meta device) to the same path counted on the card (``card``, under the
    same counting mode): FLOPs and op bytes equal, each kernel charged as
    many times, and the meta peak within ``DRYRUN_PEAK_TOL`` of the card's
    ``max_memory_allocated`` (``peak``, read after
    ``reset_peak_memory_stats``) less what was allocated beside the counted
    run's arguments (``held`` less the arguments' bytes). Prints the
    reckoned time, the larger of the compute and memory terms at the card's
    peaks (bf16 tensor cores, HBM), beside the measured ``secs``, and
    ``model_flops`` over ``secs`` at 989.4 TFLOP/s."""
    c, m = card.ops, meta.ops
    calls = lambda k: {name: v[0] for name, v in k.items()}
    require(c.flops == m.flops and c.op_bytes == m.op_bytes and c.dot_bytes == m.dot_bytes,
            f"dryrun {what}: meta FLOPs {m.flops}, op bytes {m.op_bytes}, dot bytes {m.dot_bytes} "
            f"against the card's {c.flops}, {c.op_bytes}, {c.dot_bytes}")
    require(calls(c.kernels) == calls(m.kernels),
            f"dryrun {what}: kernels charged {calls(m.kernels)} on meta, {calls(c.kernels)} on the card")
    beside = held - card.argument_bytes
    measured = peak - beside
    rel = m.peak / measured - 1
    require(abs(rel) <= DRYRUN_PEAK_TOL, f"dryrun {what}: meta peak {m.peak} B against the card's "
            f"{measured} B ({rel:+.2%}, limit {DRYRUN_PEAK_TOL:.0%})")
    compute, memory = m.flops / BF16_FLOPS, m.dot_bytes / HBM_BYTES_PER_S
    share = model_flops / (secs * BF16_FLOPS)
    row = {"path": what, "flops": m.flops, "op_bytes": m.op_bytes, "meta_peak_gib": m.peak / 2**30,
           "card_peak_gib": measured / 2**30, "peak_rel": rel, "compute_s": compute,
           "memory_s": memory, "reckoned_s": max(compute, memory), "measured_s": secs,
           "unfused_s": m.op_bytes / HBM_BYTES_PER_S, "model_flops": model_flops,
           "model_flops_share": share}
    DRYRUN_ROWS.append(row)
    print(f"dryrun {what}: FLOPs {m.flops} and op bytes {m.op_bytes} on meta = the card's; kernels "
          f"{calls(m.kernels) or 'none'} on both; peak {m.peak / 2**30:.3f} GiB on meta against "
          f"{measured / 2**30:.3f} GiB on the card ({rel:+.2%}; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB less {beside / 2**30:.3f} held beside the arguments); reckoned "
          f"{row['reckoned_s']:.4f} s (compute {compute:.4f} s at 989.4 TFLOP/s, matrix-product "
          f"bytes {memory:.4f} s at 3.35 TB/s; every op's bytes {row['unfused_s']:.4f} s) against "
          f"{secs:.4f} s measured; model FLOPs {model_flops:.4e}, {share:.2%} of 989.4 TFLOP/s "
          f"({card_line()})", flush=True)


def dryrun_train(torch, cfg, step, st, batch, meta, peers: int, rows: int, seq: int,
                 secs: float):
    """One more train step of ``step`` on the card under the counting mode
    (``launch.dryrun.count_train_step``) on contiguous copies of ``batch``,
    as ``launch.dryrun.on_meta`` makes the meta batch, beside ``meta``, the
    dry run's count of the same step on meta; ``dryrun_check``. Returns the
    state."""
    from repro_torch.launch import dryrun as D

    cbatch = {k: v.contiguous() for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    card, (st, metrics) = D.count_train_step(step, st, cbatch)
    require(math.isfinite(float(metrics["loss"])), f"dryrun {cfg.name} train: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    tokens = peers * rows * seq
    dryrun_check(torch, f"{cfg.name} train step, {peers} peers x {rows} x {seq} tokens", card, meta,
                 held, peak, secs, 6 * cfg.active_param_count() * tokens)
    return st


def dryrun_scoring(torch, mods, model, cfg, tokens, flags: dict, expect: dict) -> None:
    """The scoring forward with ``flags`` timed twice (the faster kept) and
    run once more under the counting mode (``launch.dryrun.count_forward``;
    its launches must be ``expect`` and stay out of the kernels line),
    beside the dry run's count of the same forward on meta (``meta_model``
    and the tokens' shape); ``dryrun_check``."""
    from repro_torch import models
    from repro_torch.launch import dryrun as D

    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            models.forward(model, {"tokens": tokens}, cfg, **flags)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    meta, _ = D.count_forward(D.meta_model(cfg), D.on_meta({"tokens": tokens}), cfg, **flags)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counters(mods)
    card, (logits, _) = D.count_forward(model, {"tokens": tokens}, cfg, **flags)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_counters(mods)
    require(launches == expect and bool(torch.isfinite(logits).all()),
            f"dryrun {cfg.name} scoring: launches {launches} != {expect}, or logits not finite")
    del logits
    dryrun_check(torch, f"{cfg.name} scoring, {tokens.shape[0]} x {tokens.shape[1]} tokens, {flags}",
                 card, meta, held, peak, min(secs), 2 * cfg.active_param_count() * tokens.numel())


def dryrun_phase(torch) -> None:
    """The dryrun phase's close: the card's memory against
    ``launch.mesh.HBM_BYTES`` and the rows of the paths held (the train
    steps of gemma2-2b, zamba2-1.2b and whisper-base, mamba2-370m's and
    zamba2-1.2b's scoring), all five required."""
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun card: total_memory {total} B ({total / 1e9:.2f} GB) against launch.mesh's "
          f"HBM_BYTES {CARD.HBM_BYTES:.0f} B; peaks used {BF16_FLOPS / 1e12:.1f} TFLOP/s bf16, "
          f"{FP32_FLOPS / 1e12:.1f} fp32, {HBM_BYTES_PER_S / 1e12:.2f} TB/s ({card_line()})")
    require(len(DRYRUN_ROWS) == 5, f"dryrun: {len(DRYRUN_ROWS)} of 5 paths held")
    print(f"dryrun rows: {json.dumps(DRYRUN_ROWS)}")


def release(torch) -> None:
    """Free what unreachable objects hold on the card (a step that ran out
    of memory leaves its tensors in reference cycles through its
    traceback) and return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def train_launches(cfg) -> dict:
    """Kernel launches of one LM train step: the flash forward once per
    attention layer (``attn``, ``attn_local`` or ``shared_attn``) and again
    in the backward's recompute of each remat group (``cfg.remat``: the
    attention layers of ``layer_grouping``'s groups, the tail layers once),
    its backward once per attention layer. Each Mamba-2 layer likewise
    launches ``ssd_chunked_grad``'s forward (twice in a remat group) and
    its backward once, where the layer takes that route
    (``takes_ssd_grad``), else none, and ``causal_conv_silu``'s forward and
    backward as many times where it takes the conv's kernels
    (``takes_conv``). Whisper's encoder-decoder: each
    encoder layer's attention and each decoder layer's self and cross
    attention, every layer a remat group of its own."""
    from repro_torch.models.transformer import layer_grouping

    if cfg.family == "encdec":
        calls = cfg.encoder_layers + 2 * cfg.num_layers
        return {"flash_attention": (2 if cfg.remat else 1) * calls,
                "flash_attention_backward": calls}
    period, n_groups, rem = layer_grouping(cfg)
    tail_specs = cfg.block_specs()[n_groups * len(period):]
    out = {}
    for fwd, kind, takes in (("flash_attention", lambda s: s.mixer != "mamba", True),
                             ("ssd_chunked_grad", lambda s: s.mixer == "mamba", takes_ssd_grad(cfg)),
                             ("causal_conv_silu", lambda s: s.mixer == "mamba", takes_conv(cfg))):
        grouped = n_groups * sum(map(kind, period))
        tail = sum(map(kind, tail_specs))
        if grouped + tail and takes:
            out.update({fwd: (2 if cfg.remat else 1) * grouped + tail,
                        f"{fwd}_backward": grouped + tail})
    return out


def takes_ssd_grad(cfg) -> bool:
    """Whether ``cfg``'s Mamba-2 layers take ``ssd_chunked_grad`` on the card:
    ``ssd_grad_takes`` of meta tensors laid out as ``mamba2_apply`` passes
    x, B and C (slices of the convolution's output) in ``cfg.dtype``."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_grad_takes

    H, P, G, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    conv = torch.empty((2, 64, H * P + 2 * G * N), dtype=getattr(torch, cfg.dtype), device="meta")
    x, Bm, Cm = torch.split(conv, [H * P, G * N, G * N], dim=-1)
    return ssd_grad_takes(x.unflatten(-1, (H, P)), Bm.unflatten(-1, (G, N)),
                          Cm.unflatten(-1, (G, N)), cfg.ssm_chunk)


def takes_conv(cfg) -> bool:
    """Whether ``cfg``'s Mamba-2 layers take the causal conv's kernels on the
    card in a full-sequence call: ``conv_takes`` of meta tensors laid out
    as ``mamba2_apply`` passes them (the x|B|C view of the projection) in
    ``cfg.dtype`` (none in a checkout without them: the SRC modes)."""
    import torch

    try:
        from repro_torch.kernels.causal_conv import conv_takes
    except ImportError:
        return False
    di, G, N, H = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_heads
    dt = getattr(torch, cfg.dtype)
    proj = torch.empty((2, 64, 2 * di + 2 * G * N + H), dtype=dt, device="meta")
    C = di + 2 * G * N
    return conv_takes(proj[..., di:di + C], torch.empty((cfg.ssm_conv, C), dtype=dt, device="meta"),
                      torch.empty((C,), dtype=dt, device="meta"))


CUTS = tuple((p, s) for p in range(TRAIN_PEERS, 0, -1) for s in (TRAIN_SEQ, 1024, 512, 256))


def drive_train(torch, mods, arch: str, *, steps: int = TRAIN_STEPS, schedule=None,
                cuts=((TRAIN_PEERS, TRAIN_SEQ),),
                check_launches: bool = True, recorded: dict = None, lr: float = TRAIN_LR,
                rows: int = 1, extra=None, dryrun: bool = False):
    """``arch`` at full width trained through ``train.build_train_step`` on
    the full graph: ``allgather_mean``, Adam at ``lr`` (by default the
    reference CLI's 3e-3) under ``schedule``, by default
    ``warmup_cosine(lr, steps // 10 + 1, steps)``, ``cuts[0]``'s peers x
    batch ``rows`` x its sequence (by default TRAIN_PEERS x 1 x TRAIN_SEQ
    tokens), ``steps`` steps on one fixed batch. Each of ``cuts`` (peers, sequence) is tried in
    turn from a fresh state, until one runs its steps without running out
    of memory, and each cut is printed; by default there is none to try,
    and running out of memory fails the run. The step writes the new params
    and moments into the state's tensors (``build_train_step`` donates the
    state). Every step must launch ``train_launches(cfg)`` (counters zeroed
    before and read after each step; ``check_launches=False`` for another
    checkout's port) and give a finite loss; the last loss must be below
    the first, and every leaf must have moved (its first 4096 entries,
    copied before the first step; for an untied ``embed``, the rows of the
    batch's first 8 distinct tokens: a row no token reads gets no
    gradient) but the unread params of the
    ``shared_attn`` layers (``unread_params``, reference behaviour 23),
    which must come out bit for bit as they went in, their Adam moments
    zero. ``dryrun``: the step reckoned before it runs by this checkout's
    dry run on meta (``launch.dryrun.meta_train`` on the batch's shapes:
    its peak and FLOPs printed), and one more step after the checks,
    counted on the card and held to that count (``dryrun_train``), its
    launches left out of the returned ones. ``recorded``: {name: (a test of ``kf._backward``'s (args,
    kwargs), a list)}: each list takes the arguments of the last step's
    first flash backward launch that its test accepts (the backward runs
    the layers last to first). ``rows``: each peer's batch. ``extra``:
    ``extra(generator, rows)`` gives the batch's other entries for that
    many rows (whisper's frames), made once with the tokens. Prints the
    peak device memory. Returns the launches of all the steps and the
    (config, peers, sequence) that ran."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core.p2p import Topology
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config(arch)
    n_params = models.param_count(models.init_model(cfg, generator=None, device="meta"))
    card = torch.cuda.get_device_properties(0).total_memory
    unread = unread_params(cfg)
    opt = adam()
    sched = schedule or warmup_cosine(lr, steps // 10 + 1, steps)
    expect = train_launches(cfg)
    total = dict.fromkeys(KERNELS, 0)
    for peers, seq in cuts:
        if (peers, seq) != cuts[0]:
            print(f"path {arch} train: CUT to {peers} peers x {seq} tokens")
        g = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        held = torch.cuda.memory_allocated()
        st = init_train_state(g, cfg, opt, device="cuda")
        torch.cuda.synchronize()
        print(f"path {arch} train: {n_params} params, state initialised in "
              f"{time.perf_counter() - t0:.3f} s ({held / 2**30:.2f} GiB allocated before it)")
        toks = torch.randint(0, cfg.vocab_size, (peers * rows, seq + 1), generator=g, device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **(extra(g, peers * rows) if extra else {})}
        if dryrun:  # the dry run's reckoning: the same step on the batch's shapes, on meta
            from repro_torch.launch import dryrun as D

            meta = D.meta_train(cfg, peers, rows, seq, batch=D.on_meta(batch))[0]
            print(f"path {arch} train: reckoned by the dry run at {peers} peers x {rows} x {seq} "
                  f"tokens (remat={cfg.remat}): peak {meta.ops.peak / 2**30:.2f} GiB against the "
                  f"card's {card / 2**30:.2f} GiB, {meta.ops.flops:.4e} FLOPs a step")
        read = toks[:, :-1].reshape(-1).unique()[:8]  # rows of an untied embedding that get a gradient
        sample = lambda k, p: (p[read] if k == "embed" and not cfg.tie_embeddings
                               else p.reshape(-1)[:4096])
        before = {k: sample(k, p).clone() for k, p in st.params.items()}
        kept = {k: st.params[k].clone() for k in unread}
        step = build_train_step(cfg, opt, Topology(), peers, sched)
        losses, secs, lrs, failed = [], [], [], ""
        torch.cuda.reset_peak_memory_stats()
        try:
            for i in range(steps):
                reset_counters(mods)
                torch.cuda.synchronize()
                t = time.perf_counter()
                with contextlib.ExitStack() as stack:
                    seen = {name: stack.enter_context(recording(kf, "_backward", want))
                            for name, (want, _) in (recorded or {}).items() if i == steps - 1}
                    st, metrics = step(st, batch)
                loss = float(metrics["loss"])  # synchronises
                for name, calls in seen.items():
                    recorded[name][1][:] = calls
                secs.append(time.perf_counter() - t)
                launches = read_counters(mods)
                require(not check_launches or launches == dict(dict.fromkeys(KERNELS, 0), **expect),
                        f"{arch} train step {i}: launches {launches}, expected {expect} per step")
                for name, count in launches.items():
                    total[name] += count
                losses.append(loss)
                lrs.append(metrics["lr"])
        except torch.cuda.OutOfMemoryError as e:
            failed = str(e).splitlines()[0].split(" If reserved")[0][:400]
        if not failed:
            break
        print(f"path {arch} train at {peers} peers x {seq} tokens: out of memory after "
              f"{len(losses)} steps ({failed})")
        del st, step, batch, before, kept
        release(torch)  # the failed step's tensors sit in reference cycles through its traceback
        total = dict.fromkeys(KERNELS, 0)
    else:
        require(False, f"{arch} train: no cut of sequence and peers fits the card")
    require(all(math.isfinite(x) for x in losses), f"{arch} train: non-finite loss {losses}")
    require(losses[-1] < losses[0],
            f"{arch} train: the loss did not fall on the repeated batch: {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in st.params.values()), f"{arch} train: non-finite params")
    still = [k for k, b in before.items() if torch.equal(sample(k, st.params[k]), b)]
    require(set(still) == unread, f"{arch} train: {len(still)} of {len(before)} leaves did not "
            f"move: {sorted(set(still) - unread)[:5]}; unread params that moved: "
            f"{sorted(unread - set(still))[:5]}")
    require(all(torch.equal(st.params[k], kept[k]) and float(st.opt_state["mu"][k].abs().max())
                == float(st.opt_state["nu"][k].abs().max()) == 0.0 for k in unread),
            f"{arch} train: an unread param of a shared_attn layer changed")
    del kept
    later = (f", then {sum(secs[1:]) / (steps - 1):.4f} s/step ({[round(x, 4) for x in secs[1:]]}), "
             f"{peers * rows * seq * (steps - 1) / sum(secs[1:]):.0f} tokens/s" if steps > 1 else "")
    extra_shapes = "".join(f" + {k} {tuple(v.shape)}" for k, v in batch.items()
                           if k not in ("tokens", "labels"))
    print(f"path {arch} train, {peers} peers x batch {rows} x {seq} tokens{extra_shapes}, adam lr {lr} "
          f"{'warmup_cosine' if schedule is None else 'constant'} (rates "
          f"{[round(x, 6) for x in lrs]}): first step {secs[0]:.3f} s{later}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f}), launches per "
          f"step { {k: v for k, v in expect.items() if v} or 'none' }, loss per step "
          f"{[round(x, 5) for x in losses]}, "
          + (f"the other {len(before) - len(unread)} leaves moved, the {len(unread)} unread params "
             "of the shared_attn layers bit for bit as initialised, their moments 0"
             if unread else f"all {len(before)} leaves moved"))
    if dryrun:
        reset_counters(mods)
        st = dryrun_train(torch, cfg, step, st, batch, meta, peers, rows, seq,
                          sum(secs[1:]) / (steps - 1))
        require(read_counters(mods) == dict(dict.fromkeys(KERNELS, 0), **expect),
                f"dryrun {arch} train step: launches {read_counters(mods)}, expected {expect}")
    return total, (cfg, peers, seq)


BWD_F64_MULTIPLE = 4.0  # where dq cancels: its limit's second term, in units of the plain f32's own error


def flash_bwd_dq_term_sizes(torch, kf, q, k, v, do, *, causal, softcap, window):
    """Tq f32, shaped as dq: for each element of dq the sum of the sizes of
    the terms it sums, taken before the subtraction dP - delta cancels. With
    p, dP and delta as the plain backward has them (delta_i = sum_j p_ij
    dP_ij), a_ij = p_ij (|dP_ij| + |delta_i|) |1 - t_ij^2| (no last factor
    without softcap), Tq_i = scale sum_j a_ij |k_j|."""
    s, t, valid, qf = kf._masked_scores(q.float(), k.float(), causal=causal, softcap=softcap,
                                        window=window)
    p = torch.where(valid, torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)), 0.0)
    B, Sq, H, D = q.shape
    dp = torch.einsum("bqkgd,bskd->bkgqs", do.float().reshape(qf.shape), v.float())
    a = p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())
    if softcap:
        a = a * (1 - t * t)
    return torch.einsum("bkgqs,bskd->bqkgd", a.abs(), k.float().abs()).reshape(B, Sq, H, D) \
        / math.sqrt(D)


def bwd_bf16_products(torch, kf, q, k, v, do, *, causal, softcap, window):
    """A control that the check on cancelling inputs must reject: the plain
    backward in f32 with p and dS rounded to bf16 before the products that
    read them (dv = p^T dO, dq = dS K, dk = dS^T Q), as a kernel that fed
    its tensor cores bf16 P and dS without splitting them into hi + lo
    would compute; (dq, dk, dv) rounded to bf16 as the kernel rounds."""
    s, t, valid, qf = kf._masked_scores(q.float(), k.float(), causal=causal, softcap=softcap,
                                        window=window)
    p = torch.where(valid, torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)), 0.0)
    B, Sq, H, D = q.shape
    bf16 = lambda x: x.to(torch.bfloat16).float()
    dof = do.float().reshape(qf.shape)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if softcap:
        ds = ds * (1 - t * t)
    ds, scale = bf16(ds), 1.0 / math.sqrt(D)
    grads = (torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()).reshape(B, Sq, H, D) * scale,
             torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale,
             torch.einsum("bkgqs,bqkgd->bskd", bf16(p), dof))
    return tuple(g.to(torch.bfloat16) for g in grads)


def hold_bwd_to_plain(torch, kf, seen, what: str, cfg, peers: int, seq: int, softcap: float,
                      causal_expected: bool = True, kv_seq: int = None, cancels: bool = False):
    """The backward kernel held to the plain backward in f32 on one layer's
    recorded inputs (``kf._backward``'s q, k, v, the o in f32 and lse its
    forward saved, do; the peers folded into the batch: ``peers`` rows of
    ``seq`` queries, against ``kv_seq`` keys, by default ``seq``) within
    ``flash_bwd_tolerance``. Returns the largest error.

    ``cancels`` (whisper's layers, whose cotangents are about 1e-9 to 1e-6
    and whose dq sums terms thousands of times its own size): there the
    plain backward in f32 lies tens of times outside 2e-5 max|g| from the
    same backward in f64, so no f32 sum in another order meets that limit
    against it. dq is then held to the backward in f64, each element within
    2^-8 |g| + the larger of 2e-5 max|g| and ``BWD_F64_MULTIPLE`` times the
    plain f32's own largest distance from f64; dk and dv keep the rule
    above. Printed beside it: each gradient's reading under each rule, the
    multiple that the kernel's dq needs, and dq's largest sum of terms'
    sizes over max|g|. Two controls: a skipped key tile must fail every
    gradient on its own, and the backward with bf16 products
    (``bwd_bf16_products``) must fail dq."""
    (q, k, v, o32, lse, do, causal, cap, window, *_), _ = seen[0]  # then the default scale
    require(q.dtype == torch.bfloat16 and q.shape == (peers, seq, cfg.num_heads,
                                                      cfg.resolved_head_dim)
            and k.shape[1] == (kv_seq or seq),
            f"the path's backward inputs: {q.dtype} q {tuple(q.shape)} k {tuple(k.shape)}")
    require(causal == causal_expected and cap == softcap,
            f"the path's backward: causal={causal} softcap={cap}")
    got = kf.FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, causal, cap, window)
    opts = dict(causal=causal, softcap=cap, window=window)
    ref = kf.flash_attention_backward_plain(*(t.float() for t in (q, k, v, do)), **opts)
    torch.cuda.synchronize()
    held = [(r,) + flash_bwd_tolerance(torch, r, q.dtype) for r in ref]
    if cancels:
        exact = kf.flash_attention_backward_plain(*(t.double() for t in (q, k, v, do)), **opts)
        e32 = float((ref[0].double() - exact[0]).abs().max())
        top = float(exact[0].abs().max())
        held[0] = (exact[0], 2.0 ** -8 * exact[0].abs() + max(2e-5 * top, BWD_F64_MULTIPLE * e32),
                   f"2^-8 |g| + max(2e-5 max|g|, {BWD_F64_MULTIPLE:g} x the plain f32's largest "
                   f"distance {e32:.3e}) of the backward in f64")
        Skv = k.shape[1]
        t0, kpos = Skv // 2 // 64 * 64, torch.arange(Skv, device=k.device)
        planted = [g.to(q.dtype) for g in autograd_of_plain(
            torch, kf, q, k, v, do, **opts, kv_positions=torch.where(
                (kpos >= t0) & (kpos < t0 + 64), -1, kpos))]
        control = bwd_bf16_products(torch, kf, q, k, v, do, **opts)
        cancel = float(flash_bwd_dq_term_sizes(torch, kf, q, k, v, do, **opts).max()) / top
    reading = lambda x, r, tol: float(((x.to(r.dtype) - r).abs() / tol).max())
    worst, notes = 0.0, []
    for i, (gname, a, (r, tol, rule)) in enumerate(zip(("dq", "dk", "dv"), got, held)):
        err = (a.to(r.dtype) - r).abs()
        require(bool(torch.all(err <= tol)), f"flash_attention_backward {gname} on {what}'s "
                f"inputs: max err/limit {float((err / tol).max()):.3f} ({rule})")
        worst = max(worst, float(err.max()))
        if not cancels:
            notes.append(rule)
            continue
        bad, ctl = reading(planted[i], r, tol), reading(control[i], r, tol)
        require(bad > 1, f"the backward check on {what} would pass a planted fault (a skipped "
                f"key tile) in {gname}: max err/limit {bad:.3f}")
        require(i > 0 or ctl > 1, f"the backward check on {what} would pass dq with bf16 "
                f"products: max err/limit {ctl:.3f}")
        old64, _ = flash_bwd_tolerance(torch, exact[i], q.dtype)
        old32, _ = flash_bwd_tolerance(torch, ref[i], q.dtype)
        needed = (f", the multiple it needs {float(((err - 2.0 ** -8 * r.abs()).clamp_min(0)).max()) / e32:.2f}"
                  f" (limit {BWD_F64_MULTIPLE:g}), largest sum of terms' sizes {cancel:.0f} x "
                  "max|g|" if i == 0 else "")
        notes.append(f"{gname} {float((err / tol).max()):.3f} of {rule}{needed}; under 2^-8 |g| + "
                     f"2e-5 max|g| the kernel {reading(a, ref[i], old32):.3f} against the plain "
                     f"f32 and {reading(a, exact[i], old64):.3f} against f64, the plain f32 "
                     f"{reading(ref[i], exact[i], old64):.3f} against f64; controls: a skipped key "
                     f"tile [{t0}, {t0 + 64}) {bad:.1f}, bf16 products {ctl:.1f}"
                     f"{' (both rejected)' if ctl > 1 else ' (the tile rejected)'}")
    print(f"kernel check flash_attention_backward on {what}'s q, k, v, do of a train step "
          f"{tuple(q.shape)} Skv={k.shape[1]} K={k.shape[2]} causal={causal} window={window}: "
          f"max_abs_err={worst:.3e} ("
          + (f"{notes[0]} of the plain backward in f32)" if not cancels
             else "max err/limit " + "; ".join(notes) + ")"))
    return worst


def check_flash_bwd_on_path(torch, mods, cfg, peers: int, seq: int):
    """The backward kernel on the inputs the train path gives it: one more
    gemma2-2b train step (its launches required and kept out of the kernels
    line) hands the q, k, v and do of its first local and first global
    layer's backward (and the o in f32 and lse its forward saved), the peers
    folded into the batch, to recorders. A profile of one more step from
    the same state says where a step's device time goes; its flash launches
    by body must be ``train_launches``' forwards (each layer's forward and
    its recompute) and one backward (its two tensor-core launches) a layer.
    Then the kernel is held to the plain backward on each recorded layer
    (``hold_bwd_to_plain``) and timed there (``time_flash_bwd``). Returns
    (the largest error, the global layer's timing keys: the kernels line's
    row)."""
    from repro_torch.core.p2p import Topology
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.optim import adam, constant
    from repro_torch.train import build_train_step, init_train_state

    g = torch.Generator(device="cuda").manual_seed(2)
    state = init_train_state(g, cfg, adam(), device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (peers, seq + 1), generator=g, device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = build_train_step(cfg, adam(), Topology(), peers, constant(TRAIN_LR))
    reset_counters(mods)
    # the backward runs the layers last to first: the recorders keep the last global and local layer
    with recording(kf, "_backward", lambda args, kw: args[8] == 0) as glob, \
            recording(kf, "_backward", lambda args, kw: args[8] != 0) as local:
        state, _ = step(state, batch)
    launches = read_counters(mods)
    per_step = train_launches(cfg)
    expect = dict(dict.fromkeys(KERNELS, 0), **per_step)
    require(launches == expect, f"gemma2 recording train step: launches {launches} != {expect}")
    D = cfg.resolved_head_dim
    bodies = {f"wgmma<{D}>": per_step["flash_attention"],
              **{f"{p}wgmma<{D}>": cfg.num_layers for p in ("bwd dq ", "bwd dkdv ")}}
    print_profile(f"gemma2-2b train step ({peers} peers x batch 1 x {seq} tokens)",
                  device_profile(torch, lambda: step(state, batch)), bodies)
    del state, step
    release(torch)
    worst, row = 0.0, None
    for name, seen in (("a local layer", local), ("a global layer", glob)):
        worst = max(worst, hold_bwd_to_plain(torch, kf, seen, name, cfg, peers, seq,
                                             GEMMA_SOFTCAP))
        (q, k, v, _, _, do, _, _, window, *_), _ = seen[0]
        row = time_flash_bwd(torch, kf, f"on {name}'s inputs of the train step", q, k, v, do,
                             window)
    return worst, row


SLICE_TRAIN = {  # arch -> Adam's rate on the hybrid and MoE train paths
    "zamba2-1.2b": TRAIN_LR,
    # a cut: at the reference CLI's 3e-3 granite's loss rises over the 4
    # steps (``granite_cli_rate``); at 3e-4 it falls
    "granite-moe-3b-a800m": 3e-4,
}


def drive_slice_train(torch, mods, arch: str):
    """``drive_train`` of ``arch`` at ``SLICE_TRAIN``'s rate (zamba2-1.2b
    through ``ssd_chunked``, as the reference's ``lm_loss`` defaults;
    granite-moe-3b-a800m with the dense dispatch, the reference trainer's
    default), remat on as published, its last step recording its last
    attention layer's flash backward; the backward kernel is then held to
    the plain backward on those inputs (``hold_bwd_to_plain``, no softcap).
    zamba2-1.2b's step is held to the dry run's count too (``dryrun``).
    Returns (the launches of the steps, the largest error)."""
    from repro_torch.kernels import flash_attention as kf

    seen = []
    counts, (cfg, peers, seq) = drive_train(torch, mods, arch,
                                            recorded={"last": (lambda args, kw: True, seen)},
                                            lr=SLICE_TRAIN[arch], dryrun=arch == "zamba2-1.2b")
    release(torch)
    err = hold_bwd_to_plain(torch, kf, seen, f"{arch}'s last attention layer", cfg, peers, seq,
                            cfg.attn_logit_softcap)
    return counts, err


def granite_cli_rate(torch):
    """granite-moe-3b-a800m's train steps of ``drive_train`` (its seed, its
    fixed batch, ``warmup_cosine``) at the reference CLI's rate, TRAIN_LR,
    in place of ``SLICE_TRAIN``'s cut: once with flash's kernels and once
    with ``flash_attention_plain`` in their place (autograd's backward of
    the plain version, no kernel launched). Each step's loss and the
    peers' cross-entropies are printed; the two runs' losses must agree
    within 5 % (relative) at every step, so that whatever the
    loss does at this rate is not the kernels' doing. The launches are not
    counted in the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.core.p2p import Topology
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import layers
    from repro_torch.optim import adam, warmup_cosine
    from repro_torch.train import build_train_step, init_train_state

    cfg = get_config("granite-moe-3b-a800m")
    tolerance = 0.05  # bf16 trajectories of 4 steps; the rise at 3e-3 is about 30 %
    runs = {}
    for route in ("kernels", "plain"):
        g = torch.Generator(device="cuda").manual_seed(0)
        st = init_train_state(g, cfg, adam(), device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_PEERS, TRAIN_SEQ + 1), generator=g,
                             device="cuda")
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = build_train_step(cfg, adam(), Topology(), TRAIN_PEERS,
                                warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1, TRAIN_STEPS))
        layers.flash_attention = kf.flash_attention if route == "kernels" else kf.flash_attention_plain
        try:
            out = []
            for _ in range(TRAIN_STEPS):
                st, metrics = step(st, batch)
                out.append((float(metrics["loss"]), [round(float(c), 4) for c in metrics["aux"]]))
        finally:
            layers.flash_attention = kf.flash_attention
        runs[route] = out
        del st, step, batch
        release(torch)
    for route, out in runs.items():
        print(f"path granite-moe-3b-a800m train at the CLI's Adam {TRAIN_LR}, flash by "
              f"{'its kernels' if route == 'kernels' else 'flash_attention_plain'}: "
              f"loss (cross-entropy of each peer) per step "
              + ", ".join(f"{loss:.5f} ({ce})" for loss, ce in out))
    gap = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs["kernels"], runs["plain"]))
    require(all(math.isfinite(x[0]) for x in runs["kernels"] + runs["plain"]) and gap <= tolerance,
            f"granite-moe-3b-a800m at Adam {TRAIN_LR}: the kernels' and the plain version's "
            f"losses {runs} lie {gap:.3e} apart, beyond {tolerance}")
    print(f"path granite-moe-3b-a800m train at the CLI's rate: the two runs' losses within "
          f"{gap:.3e} of each other (relative; limit {tolerance})")


def drive_whisper_train(torch, mods):
    """whisper-base at full width trained through ``train.build_train_step``
    as the LM train paths (``drive_train``): ``allgather_mean``, Adam at the
    train paths' 3e-3 under ``warmup_cosine``, remat on as published (every
    encoder and decoder layer run again in the backward), 2 peers x 8 rows
    of (1500 frames, 448 tokens), 4 steps on one fixed batch: 36 flash
    forwards (each of the 18 attention calls and its recompute) and 18
    backwards a step, the peers folded into the batch. The last step
    records the flash backward's inputs of the last encoder layer (non-
    causal, 1500 x 1500), of the last decoder layer's cross attention
    (448 queries over 1500 keys), whose gradient reaches the encoder
    through its K/V, and of the last decoder layer's causal self-attention
    (448 x 448); the backward kernel is then held to the plain backward on
    each (``hold_bwd_to_plain`` with ``cancels``: their cotangents are tiny
    and dq cancels, so dq is held to the backward in f64) and timed on the
    first two (``time_bwd_against_sdpa``). Returns (the launches of the
    steps, the largest error)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf

    cfg = get_config("whisper-base")
    E = cfg.encoder_seq
    square = lambda args: args[0].shape[1] == args[1].shape[1]
    encoder, cross, decoder = [], [], []
    counts, (cfg, peers, seq) = drive_train(
        torch, mods, "whisper-base", cuts=((TRAIN_PEERS, WHISPER_TEXT),), rows=WHISPER_TRAIN_ROWS,
        extra=lambda g, rows: stub_inputs(torch, cfg, rows, g, "cuda"), dryrun=True,
        recorded={"encoder": (lambda a, kw: not a[6] and square(a), encoder),
                  "cross": (lambda a, kw: not a[6] and not square(a), cross),
                  "decoder": (lambda a, kw: a[6], decoder)})
    release(torch)
    rows = peers * WHISPER_TRAIN_ROWS
    err = 0.0
    for what, seen, q_seq, kv_seq, causal in (("last encoder layer", encoder, E, E, False),
                                               ("last cross attention", cross, seq, E, False),
                                               ("last decoder self-attention", decoder, seq, seq,
                                                True)):
        err = max(err, hold_bwd_to_plain(torch, kf, seen, f"whisper-base's {what}", cfg, rows,
                                         q_seq, 0.0, causal_expected=causal, kv_seq=kv_seq,
                                         cancels=True))
        release(torch)
    for what, seen in (("last encoder layer", encoder), ("last cross attention", cross)):
        time_bwd_against_sdpa(torch, kf, f"on whisper-base's {what}'s train-step inputs", *seen[0][0][:6])
    del encoder, cross, decoder
    release(torch)
    return counts, err


def time_bwd_against_sdpa(torch, kf, what: str, q, k, v, o32, lse, do, causal: bool = False):
    """The backward kernel (its two launches, from the o in f32 and lse a
    forward saved), its plain version (plain, kernel, kernel, plain) and
    the backward of ``scaled_dot_product_attention`` (``is_causal`` as
    ``causal``, no softcap, no window: the same function, a yardstick the
    port never calls), on these bf16 inputs, beside the bound. Printed
    only."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    kern = lambda: kf.FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, causal, 0.0, 0)
    plain = lambda: kf.flash_attention_backward_plain(q, k, v, do, causal=causal)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*leaves, is_causal=causal, enable_gqa=True)
    lib = lambda: torch.autograd.grad(o, leaves, do.transpose(1, 2), retain_graph=True)
    lib_err = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
                  for a, b in zip(lib(), kern()))
    t_plain1, _ = time_ms(torch, plain, 3)
    t_kern1, host = time_ms(torch, kern, 20)
    t_kern2, _ = time_ms(torch, kern, 20)
    t_plain2, _ = time_ms(torch, plain, 3)
    t_lib, _ = time_ms(torch, lib, 20)
    bound, by, nbytes, ops = flash_bound(torch, q, k, 0, backward=True, causal=causal)
    print(f"timing flash_attention_backward {what} {tuple(q.shape)} Skv={k.shape[1]} "
          f"K={k.shape[2]} bf16 {'causal' if causal else 'non-causal'}: kernel "
          f"{t_kern1:.4f}/{t_kern2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound "
          f"{bound:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s, {nbytes / 1e6:.1f} MB at "
          f"3.35 TB/s; roofline share {bound / min(t_kern1, t_kern2):.1%}), host enqueue "
          f"{host * 1e3:.1f} us/call, library scaled_dot_product_attention's backward "
          f"{t_lib:.4f} ms, max |SDPA - kernel| {lib_err:.3e}")
    del o, leaves
    torch.cuda.empty_cache()


def whisper_timing(torch, kf):
    """The flash forward at whisper-base's scoring shapes, bf16, as its
    scoring forward calls it (under ``torch.inference_mode()``): the
    encoder's (16, 1500, 8, 64) and the cross attention's 448 queries over
    1500 keys, both non-causal, and the decoder's causal (16, 448, 8, 64);
    each beside its plain version, its bound (the pairs its mask keeps:
    all Sq x Skv without the causal mask) and ``scaled_dot_product_attention``
    with the same mask, which computes the same function there (no
    softcap, no window). Printed only: the kernels line keeps the rows of
    ``flash_timing`` and the train path."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    E, T = 1500, WHISPER_TEXT
    for what, (Sq, Skv, causal) in (("encoder", (E, E, False)), ("cross attention", (T, E, False)),
                                    ("decoder self-attention", (T, T, True))):
        q, k, v = flash_inputs(torch, WHISPER_ROWS, Sq, Skv, 8, 8, 64, torch.bfloat16, seed=6)

        def kern():
            with torch.inference_mode():
                return kf.flash_attention(q, k, v, causal=causal)

        qt, kt_, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = lambda: sdpa(qt, kt_, vt, is_causal=causal)
        lib_err = float((lib().transpose(1, 2).float() - kern().float()).abs().max())
        t_plain1, _ = time_ms(torch, lambda: kf.flash_attention_plain(q, k, v, causal=causal), 3)
        t_kern1, host = time_ms(torch, kern, 20)
        t_kern2, _ = time_ms(torch, kern, 20)
        t_plain2, _ = time_ms(torch, lambda: kf.flash_attention_plain(q, k, v, causal=causal), 3)
        t_lib, _ = time_ms(torch, lib, 20)
        bound, by, nbytes, ops = flash_bound(torch, q, k, 0, causal=causal)
        print(f"timing flash_attention (whisper-base {what}) {(WHISPER_ROWS, Sq, 8, 64)} Skv={Skv} "
              f"bf16 {'causal' if causal else 'non-causal'}: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, "
              f"plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s; "
              f"roofline share {bound / min(t_kern1, t_kern2):.1%}), host enqueue "
              f"{host * 1e3:.1f} us/call, library scaled_dot_product_attention {t_lib:.4f} ms, "
              f"max |SDPA - kernel| {lib_err:.3e}")
        del q, k, v, qt, kt_, vt
    torch.cuda.empty_cache()


def drive_mamba_train(torch, mods):
    """Two mamba2-370m train steps at full width through the gradient of
    ``ssd_chunked`` (``use_ssd_kernel=False``, the reference's default; on
    the card ``ssd_chunked_grad``'s forward and backward kernels) at Adam's
    constant rate TRAIN_LR, with ``drive_train``'s cuts and checks (the loss
    falls, every leaf moves). Then the same step with
    ``use_ssd_kernel=True`` must refuse (grad mode through the SSD kernel,
    reference behaviour 18) before any launch."""
    from repro_torch.core.p2p import Topology
    from repro_torch.optim import adam, constant
    from repro_torch.train import build_train_step, init_train_state

    counts, (cfg, peers, seq) = drive_train(torch, mods, "mamba2-370m", steps=2,
                                            schedule=constant(TRAIN_LR))
    release(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(g, cfg, adam(), device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (peers, seq + 1), generator=g, device="cuda")
    step = build_train_step(cfg, adam(), Topology(), peers, constant(TRAIN_LR), use_ssd_kernel=True)
    reset_counters(mods)
    try:
        step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    require("reference behaviour 18" in refused and read_counters(mods)["ssd_scan"] == 0,
            f"mamba2 train step with use_ssd_kernel=True: {refused!r}, "
            f"{read_counters(mods)['ssd_scan']} SSD launches")
    print("path mamba2-370m train with use_ssd_kernel=True: RuntimeError (reference behaviour 18) "
          "before any SSD launch")
    return counts


def remat_phase(torch, mods):
    """One train step of a 3-layer reduced gemma2-2b in f32 (one remat
    group of a local and a global layer, one tail layer; S 160 over its
    window of 64), 2 peers x batch 2, ``allgather_mean``, plain SGD at rate
    1, on the card from one state with ``cfg.remat`` on and off: the same
    loss, every leaf's update within 1e-4 of its largest magnitude (the
    reduced step's card limit: the recompute's generated vmap rule sums
    each group's per-peer gradients where one product over the folded peers
    sums them without it), and ``train_launches``' counts: 5 flash forwards
    with remat (the group's two layers twice, the tail once), 3 without, 3
    backwards either way. The same for a 3-layer reduced zamba2-1.2b (one
    group of a Mamba-2 layer and a layer applying the shared block, whose
    params go into the group's Function as inputs; a Mamba-2 tail layer;
    through ``ssd_chunked``): 2 flash forwards against 1, one backward, the
    shared_attn layer's unread params unmoved."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.p2p import Topology
    from repro_torch.optim import sgd
    from repro_torch.train import build_train_step, init_train_state

    for arch in ("gemma2-2b", "zamba2-1.2b"):
        base = dataclasses.replace(reduced(get_config(arch), num_layers=3), dtype="float32")
        unread = unread_params(base)
        state = init_train_state(torch.Generator().manual_seed(0), base, sgd(), device="cpu")
        toks = torch.randint(0, base.vocab_size, (2 * TRAIN_PEERS, 161),
                             generator=torch.Generator().manual_seed(1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for remat in (True, False):
            cfg = dataclasses.replace(base, remat=remat)
            st = state.replace(params={k: p.to("cuda", copy=True) for k, p in state.params.items()})
            step = build_train_step(cfg, sgd(), Topology(), TRAIN_PEERS, lambda s: 1.0)
            reset_counters(mods)
            new, metrics = step(st, batch)
            launches = read_counters(mods)
            expect = dict(dict.fromkeys(KERNELS, 0), **train_launches(cfg))
            require(launches == expect, f"reduced {arch} step remat={remat}: launches {launches} "
                    f"!= {expect}")
            out[remat] = ({k: state.params[k] - p.cpu() for k, p in new.params.items()},
                          float(metrics["loss"]), launches["flash_attention"])
        (dr, lr_, fr), (dn, ln, fn) = out[True], out[False]
        require(abs(lr_ - ln) <= 1e-6 * abs(ln), f"reduced {arch} step: loss {lr_} with remat, "
                f"{ln} without")
        require(all(float(dr[k].abs().max()) == float(dn[k].abs().max()) == 0.0 for k in unread),
                f"reduced {arch} step: an unread param of a shared_attn layer moved")
        worst = 0.0
        for k, want in dn.items():
            if k in unread:
                continue
            err, scale = float((dr[k] - want).abs().max()), float(want.abs().max())
            require(err <= 1e-4 * scale, f"reduced {arch} step: {k} update {err:.3e} with remat "
                    f"from without, beyond 1e-4 x {scale:.3e}")
            worst = max(worst, err / scale)
        print(f"reference check (reduced {arch} train step on the card, 3 layers, f32, remat on "
              f"against off): loss {lr_:.7f} vs {ln:.7f}, every leaf's update within {worst:.3e} "
              f"of its largest magnitude (limit 1e-4), flash forwards {fr} vs {fn}"
              + (f", the {len(unread)} unread params unmoved" if unread else ""))


def leaf_sample(p):
    """65,536 entries spread over a leaf: an embedding's rows of the tokens
    a batch holds are among them (its first rows may hold none)."""
    return p.reshape(-1)[::max(1, p.numel() // 65536)]


def _counted_steps(torch, mods, expect, losses, secs, before, last_hook=None):
    """A stand-in for ``P2PTrainer.step`` that zeroes the launch counters
    before each step and requires ``expect`` after it (None: no check),
    keeps each step's loss and time and ``leaf_sample`` of every leaf
    before the first step; ``last_hook(run)`` wraps the call of step
    number ``last_hook.step``. Returns (the stand-in, the total launches)."""
    from repro_torch.train import P2PTrainer

    step, total = P2PTrainer.step, dict.fromkeys(KERNELS, 0)

    def counted(self, state, batch):
        if not before:
            before.update({k: leaf_sample(p).clone() for k, p in state.params.items()})
        reset_counters(mods)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run = lambda: step(self, state, batch)
        out = (last_hook(run) if last_hook is not None and len(losses) == last_hook.step
               else run())
        losses.append(float(out[1]["loss"]))  # synchronises
        secs.append(time.perf_counter() - t)
        launches = read_counters(mods)
        require(expect is None or launches == expect,
                f"train CLI step {len(losses)}: launches {launches} != {expect}")
        for name, count in launches.items():
            total[name] += count
        return out

    return counted, total


@contextlib.contextmanager
def trainer_steps(stand_in):
    from repro_torch.train import P2PTrainer

    step = P2PTrainer.step
    P2PTrainer.step = stand_in
    try:
        yield
    finally:
        P2PTrainer.step = step


def drive_cli_train(torch, mods):
    """The train CLI twin at full width: ``repro_torch.launch.train.main``
    with ``--full --arch qwen2.5-3b --data-parallel 2 --batch 2 --seq 2048
    --steps 4 --exchange allgather_mean --backend instance
    --serverless-report`` through ``P2PTrainer`` (its step:
    ``build_train_step``, remat on as configured; the CLI prints its step
    lines and the instance accounting of the measured steps). The
    serverless accounting and the cost frontier refuse this model, as the
    reference's do: its 13.6 GB of f32 params need 27,904 MB of Lambda
    memory, above the 10,240 MB cap (``ServerlessPlanner``'s ValueError);
    the reduced CLI run below prints both.
    Every step must launch ``train_launches(cfg)`` (72 flash forwards, 36
    backwards), the losses be finite, every leaf move. Prints s/step after
    the first and the peak device memory. Then the backward kernel is held
    to the plain backward on the inputs of the last step's last layer
    (qwen2.5-3b's 16 heads over 2, D 128, no softcap). Returns the
    launches of the four steps and the largest error."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.launch import train as cli

    cfg = get_config("qwen2.5-3b")
    n_params = models.param_count(models.init_model(cfg, generator=None, device="meta"))
    print(f"path qwen2.5-3b train CLI: {n_params} params")
    expect = dict(dict.fromkeys(KERNELS, 0), **train_launches(cfg))
    losses, secs, before, seen = [], [], {}, []

    def record_last(run):
        with recording(kf, "_backward") as last:
            out = run()
        seen.extend(last)
        return out

    record_last.step = TRAIN_STEPS - 1
    stand_in, total = _counted_steps(torch, mods, expect, losses, secs, before, record_last)
    torch.cuda.reset_peak_memory_stats()
    with trainer_steps(stand_in):
        state = cli.main(["--full", "--arch", "qwen2.5-3b", "--data-parallel", str(TRAIN_PEERS),
                          "--batch", str(TRAIN_PEERS), "--seq", str(TRAIN_SEQ),
                          "--steps", str(TRAIN_STEPS), "--exchange", "allgather_mean",
                          "--backend", "instance", "--serverless-report", "--log-every", "1"])
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    require(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
            f"qwen2.5-3b train CLI: losses {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in state.params.values()),
            "qwen2.5-3b train CLI: non-finite params")
    still = [k for k, b in before.items() if torch.equal(leaf_sample(state.params[k]), b)]
    require(not still, f"qwen2.5-3b train CLI: {len(still)} of {len(before)} leaves did not move: "
            f"{still[:5]}")
    print(f"path qwen2.5-3b train CLI, {TRAIN_PEERS} peers x batch 1 x {TRAIN_SEQ} tokens: first step "
          f"{secs[0]:.3f} s, then {sum(secs[1:]) / (len(secs) - 1):.4f} s/step "
          f"({[round(x, 4) for x in secs[1:]]}), "
          f"{TRAIN_PEERS * TRAIN_SEQ * (len(secs) - 1) / sum(secs[1:]):.0f} tokens/s, peak device "
          f"memory {peak / 2**30:.2f} GiB (reserved {reserved / 2**30:.2f}), launches per step "
          f"{ {k: v for k, v in expect.items() if v} }, loss per step "
          f"{[round(x, 5) for x in losses]}, all {len(before)} leaves moved")
    del state
    release(torch)
    err = hold_bwd_to_plain(torch, kf, seen, "qwen2.5-3b's last layer", cfg, TRAIN_PEERS,
                            TRAIN_SEQ, 0.0)
    return total, err


def drive_cli_checkpoint(torch, mods):
    """The train CLI at ``reduced(qwen2.5-3b)`` with ``remat`` put back, 2
    peers x batch 2 x 256 tokens, ``--exchange qsgd --ef`` (the QSGD
    kernels), ``--cost-report --serverless-report`` (the serverless
    accounting and the cost frontier of the card's step times): 3 steps
    written with ``--checkpoint``; then one step
    ``--restore``d from the file, and the same command again with the
    state held in memory in place of the file: the two resumed states must
    be the same bits (params, Adam's moments and step count, the EF bank,
    the step). The serve twin's ``--checkpoint`` then reads the file.
    Returns the launches of the CLI runs."""
    import io

    from repro_torch.configs import reduced
    from repro_torch.launch import serve
    from repro_torch.launch import train as cli
    from repro_torch.train import P2PTrainer

    path = ROOT / "build" / "smoke_ckpt" / "qwen_qsgd_ef"
    path.parent.mkdir(parents=True, exist_ok=True)
    argv = ["--arch", "qwen2.5-3b", "--data-parallel", "2", "--batch", "4", "--seq", "256",
            "--exchange", "qsgd", "--ef", "--log-every", "1", "--cost-report",
            "--serverless-report"]
    losses, secs, before = [], [], {}
    stand_in, total = _counted_steps(torch, mods, None, losses, secs, before)
    with_remat = lambda cfg, **kw: reduced(cfg, remat=True, **kw)
    cli.reduced, restore = with_remat, P2PTrainer.restore
    try:
        with trainer_steps(stand_in):
            saved = cli.main(argv + ["--steps", "3", "--checkpoint", str(path)])
            from_file = cli.main(argv + ["--steps", "1", "--restore", str(path)])
            P2PTrainer.restore = lambda self, p, like=None: saved
            in_memory = cli.main(argv + ["--steps", "1", "--restore", str(path)])
    finally:
        cli.reduced, P2PTrainer.restore = reduced, restore
    require(total["qsgd_quantize"] > 0 and total["qsgd_dequant_reduce"] > 0,
            f"reduced qwen2.5-3b qsgd CLI: launches {total}")
    require(from_file.step == in_memory.step == 4, f"resumed steps {from_file.step}, "
            f"{in_memory.step}")
    same = lambda a, b: a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    require(same(from_file.params, in_memory.params) and same(from_file.ef, in_memory.ef)
            and all(same(from_file.opt_state[m], in_memory.opt_state[m]) for m in ("mu", "nu"))
            and torch.equal(from_file.opt_state["t"], in_memory.opt_state["t"])
            and losses[3] == losses[4],
            "reduced qwen2.5-3b qsgd CLI: the step resumed from the checkpoint differs from the "
            "step from the state held in memory")
    print(f"path reduced qwen2.5-3b train CLI (remat, qsgd + EF, 2 peers x 2 x 256 tokens): "
          f"losses {[round(x, 5) for x in losses[:3]]}, checkpoint {path.name}.npz; the step "
          f"resumed from it and the step from the state in memory the same bits (loss "
          f"{losses[3]:.6f}, every param, moment and EF row); launches "
          f"{ {k: v for k, v in total.items() if v} }")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen2.5-3b", "--checkpoint", str(path), "--gen", "4",
                    "--batch", "2"])
    require("restored checkpoint (step 3)" in out.getvalue(), f"serve: {out.getvalue()!r}")
    print("path serve twin --checkpoint of that file: " + " | ".join(out.getvalue().splitlines()))
    return total


def drive_example(torch, mods):
    """The example twin (``examples/p2p_serverless_train.py``'s qwen-100m,
    qsgd(127, 2048), grad clip 1.0, through ``P2PTrainer``) for 3 steps of
    2 peers x 4 x 128 tokens, its checkpoint under build/: finite losses,
    every leaf moved, the QSGD kernels launched. Returns its launches."""
    from repro_torch.examples import p2p_serverless_train

    losses, secs, before = [], [], {}
    stand_in, total = _counted_steps(torch, mods, None, losses, secs, before)
    with trainer_steps(stand_in):
        state = p2p_serverless_train.main([
            "--steps", "3", "--peers", "2", "--batch", "8", "--seq", "128",
            "--checkpoint", str(ROOT / "build" / "smoke_ckpt" / "example")])
    still = [k for k, b in before.items() if torch.equal(leaf_sample(state.params[k]), b)]
    require(all(math.isfinite(x) for x in losses) and not still and total["qsgd_quantize"] > 0,
            f"example twin: losses {losses}, {len(still)} leaves still, launches {total}")
    print(f"path example twin (qwen-100m, qsgd, 2 peers x 4 x 128 tokens): losses "
          f"{[round(x, 5) for x in losses]}, s/step {[round(x, 4) for x in secs]}, all "
          f"{len(before)} leaves moved, launches { {k: v for k, v in total.items() if v} }")
    del state
    release(torch)
    return total


def drive_serve_decode(torch, mods):
    """The serve_decode example twin on the card as a user runs it
    (``python -m repro_torch.examples.serve_decode``): gemma2-2b,
    mamba2-370m and zamba2-1.2b reduced as the reference's example reduces
    them, 4 requests x 48 greedy tokens each. Decode launches no kernel
    (``attend`` over the KV caches, the SSM step), as in the reference;
    each of its three lines must name its arch and family and give a rate
    and a sample of tokens in the vocabulary."""
    import io

    from repro_torch.examples import serve_decode

    out = io.StringIO()
    reset_counters(mods)
    with contextlib.redirect_stdout(out):
        serve_decode.main([])
    launches = read_counters(mods)
    lines = out.getvalue().splitlines()
    require(not any(launches.values()), f"serve_decode twin: launches {launches}")
    require(len(lines) == len(serve_decode.ARCHS), f"serve_decode twin printed {lines}")
    for arch, line in zip(serve_decode.ARCHS, lines):
        sample = [int(x) for x in line.split("sample: [")[1].rstrip("]").split(",")]
        require(line.startswith(arch) and " tok/s " in line and len(sample) == 10
                and all(0 <= t < 512 for t in sample), f"serve_decode twin's line: {line}")
        print(f"path serve_decode twin: {line}")


def profile_phase(torch, name, model, cfg, tokens, prompts, flags, bodies):
    """Device busy and idle share and kernel time by kind, from
    ``torch.profiler``, over one scoring forward (with ``flags``; its flash
    and SSD launches by body must be ``bodies``) and over 4 decode steps at
    the prompts' batch after their prefill (no flash or SSD launch). Last,
    because the profiler leaves host-side costs behind that slow later
    host-bound work."""
    from repro_torch import models

    with torch.inference_mode():
        print_profile(f"{name} scoring forward {tuple(tokens.shape)}", device_profile(
            torch, lambda: models.forward(model, {"tokens": tokens}, cfg, **flags)), bodies)
        state0 = models.init_decode_state(cfg, prompts.shape[0], prompts.shape[1] + 4, device="cuda")
        logits, state = models.prefill(model, state0, {"tokens": prompts}, cfg)
        tok = logits.argmax(-1)[:, None]

        def decode4():
            st = state
            for _ in range(4):
                _, st = models.decode_step(model, st, tok, cfg)

        print_profile(f"{name} 4 decode steps (batch {prompts.shape[0]})",
                      device_profile(torch, decode4), {})


# ---------------------------------------------------------------------------
# 5. timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int = 50):
    """(device ms per call, host ms per call to enqueue it).

    A spin kernel first keeps the card busy while the host enqueues the
    timed calls, so the events time the device and not the launch path
    (the wrappers' Python and ctypes overhead, slower still once the
    cluster's stage probes have turned tracemalloc on)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of device cycles
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def timing_phase(torch, kq, kt, only=None):
    """Each kernel at the main path's largest shape, in turns with its plain
    version (plain, kernel, kernel, plain), and the one PyTorch call that
    computes the same function where there is one. Bounds count each input
    byte read once and each output byte written once, at 3.35 TB/s, and the
    function's fp32 operations at 67 TFLOP/s; the larger bounds it.
    ``only``: time that kernel alone."""
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    x = torch.randn((FC2_ROWS, BUCKET), generator=g, device="cuda") * 0.01
    u = torch.rand((FC2_ROWS, BUCKET), generator=g, device="cuda")
    lev, nrm = kq.quantize_plain(x, u, S)
    n, rows = x.numel(), FC2_ROWS
    # the device step's fc2/w leaf: 4 peers' levels and norms, 1/P weights
    lev4 = torch.randint(-S, S + 1, (PEERS, rows, BUCKET), generator=g, device="cuda", dtype=torch.int8)
    nrm4 = torch.rand((PEERS, rows), generator=g, device="cuda")
    w4 = torch.full((PEERS,), 1.0 / PEERS, device="cuda")
    flat = x.reshape(-1)
    sel_v, sel_i = kt.select_pack_plain(flat, FC2_K)
    vals4 = torch.stack([sel_v * (p + 1) for p in range(PEERS)])
    idx4 = torch.stack([sel_i] * PEERS)  # the peers share every index
    idx64 = idx4.reshape(-1).long()
    k = FC2_K
    cases = (
        # name, kernel, plain, library call, (fp32 operations, bytes): the kernel's cost function
        ("qsgd_quantize", lambda: kq.qsgd_quantize(x, u, S), lambda: kq.quantize_plain(x, u, S),
         None, COST.qsgd_quantize_cost(rows, BUCKET)),
        ("qsgd_dequantize", lambda: kq.qsgd_dequantize(lev, nrm, S),
         lambda: kq.dequantize_plain(lev, nrm, S), None, COST.qsgd_dequantize_cost(rows, BUCKET)),
        ("qsgd_dequant_reduce", lambda: kq.qsgd_dequant_reduce(lev4, nrm4, w4, S),
         lambda: kq.dequant_reduce_plain(lev4, nrm4, w4, S), None,
         COST.qsgd_dequant_reduce_cost(PEERS, rows, BUCKET)),
        # library: the same function at uniform weights, up to the atomics' summation order
        ("topk_scatter_accum", lambda: kt.topk_scatter_accum(vals4, idx4, w4, n),
         lambda: kt.scatter_accum_plain(vals4, idx4, w4, n),
         lambda: torch.zeros((n,), device="cuda").index_add_(0, idx64, vals4.view(-1), alpha=1 / PEERS),
         COST.topk_scatter_cost(PEERS, k, 1, n)),
    )
    out = {}
    for name, kern, plain, library, (ops, nbytes) in cases:
        if only and name != only:
            continue
        iters = 50
        t_plain1, _ = time_ms(torch, plain, iters)
        t_kern1, host1 = time_ms(torch, kern, iters)
        t_kern2, host2 = time_ms(torch, kern, iters)
        t_plain2, _ = time_ms(torch, plain, iters)
        t_lib = None if library is None else time_ms(torch, library, iters)[0]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS * 1e3
        out[name] = {
            "ms": min(t_kern1, t_kern2),
            "plain_ms": min(t_plain1, t_plain2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": t_lib,
        }
        print(
            f"timing {name}: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, "
            f"plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {out[name]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.3f} GFLOP at 67 TFLOP/s; roofline "
            f"share {out[name]['bound_ms'] / out[name]['ms']:.1%}), host enqueue "
            f"{min(host1, host2) * 1e3:.1f} us/call, library "
            + ("none: no single PyTorch call computes it" if t_lib is None else f"{t_lib:.4f} ms "
               f"({t_lib / out[name]['ms']:.2f}x the kernel)")
        )
    return out


def select_timing(torch, kt):
    """The select, its plain version and ``torch.topk`` of the magnitudes
    (which computes the same top-k set on tie-free input, in another
    order), at fc2/w alone (the kernels line's row) and at (4, n) banks of
    the device step: 240 (mobilenet-v3-small's median leaf), 82,944 and
    589,824 entries a row, then one device step's 180 bank selects
    together. Bound: bytes, each row read once (4 B an entry) and its k
    values and indices written once (8 B each). ``kt`` without a bank
    select (an earlier checkout's) launches once per row, as its device
    step did."""
    bank = getattr(kt, "topk_select_pack_bank", None)
    if bank is None:
        bank = lambda x, k: [kt.topk_select_pack(row, k) for row in x]
    plain_bank = lambda x, k: [kt.select_pack_plain(row, k) for row in x]
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    flat = (torch.randn((FC2_ROWS, BUCKET), generator=g, device="cuda") * 0.01).reshape(-1)
    out = {}
    cases = [("fc2/w", flat[None], FC2_K)]
    for n in (240, 82944, 589824):
        cases.append((f"bank ({PEERS}, {n})", torch.randn((PEERS, n), generator=g, device="cuda") * 0.01,
                      topk_k(n)))
    for what, x, k in cases:
        rows, n = x.shape
        if rows == 1:
            kern, plain = lambda: kt.topk_select_pack(x[0], k), lambda: kt.select_pack_plain(x[0], k)
            library = lambda: torch.topk(x[0].abs(), k)
        else:
            kern, plain = lambda: bank(x, k), lambda: plain_bank(x, k)
            library = lambda: torch.topk(x.abs(), k, dim=1)
        iters = 10 if n == FC2 else 50
        t_plain1, _ = time_ms(torch, plain, iters)
        t_kern1, host1 = time_ms(torch, kern, iters)
        t_kern2, host2 = time_ms(torch, kern, iters)
        t_plain2, _ = time_ms(torch, plain, iters)
        t_lib, _ = time_ms(torch, library, iters)
        nbytes = COST.topk_select_cost(rows, n, k)[1]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2), "bound_ms": bound,
               "bound_by": "bytes", "library_ms": t_lib}
        print(f"timing topk_select_pack {what}, k {k}: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, plain "
              f"{t_plain1:.4f}/{t_plain2:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s; "
              f"roofline share {bound / row['ms']:.1%}), host enqueue {min(host1, host2) * 1e3:.1f} us/call, "
              f"library torch.topk of the magnitudes {t_lib:.4f} ms ({t_lib / row['ms']:.2f}x the kernel)")
        if n == FC2:
            out["topk_select_pack"] = row
    leaves = [torch.randn((PEERS, n), generator=g, device="cuda") * 0.01 for n in mobilenet_leaf_sizes(torch)]
    step = lambda: [bank(x, topk_k(x.shape[1])) for x in leaves]
    t_step, host_step = time_ms(torch, step, 2)
    t_lib, _ = time_ms(torch, lambda: [torch.topk(x.abs(), topk_k(x.shape[1]), dim=1) for x in leaves], 2)
    nbytes = sum(COST.topk_select_cost(PEERS, x.shape[1], topk_k(x.shape[1]))[1] for x in leaves)
    print(f"timing topk_select_pack, one mobilenet-v3-small device step's {len(leaves)} bank selects "
          f"({PEERS} peers): device {t_step:.4f} ms, host enqueue {host_step:.4f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB), library torch.topk per "
          f"leaf {t_lib:.4f} ms")
    if hasattr(kt, "select_launch"):
        select_sweep(torch, kt)
    return out


def select_sweep(torch, kt):
    """Both bodies of the select (one block per row, the cooperative grid)
    at rows of n entries, for one row and for a bank of 4: the one-block
    body's threshold (``small_row_max``) is the longest row where it is
    no slower."""
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    for rows in (1, PEERS):
        line = []
        for n in (1024, 4096, 8192, 12288, 16384, 24576, 32768, 49152, 65536, 81920, 90112,
                  98304, 131072, 262144, 589824):
            x = torch.randn((rows, n), generator=g, device="cuda") * 0.01
            k = topk_k(n)
            one, _ = time_ms(torch, lambda: kt.select_launch(x, k, 1), 20)
            grid, _ = time_ms(torch, lambda: kt.select_launch(x, k, 2), 20)
            line.append(f"{n}: {one:.4f}/{grid:.4f}")
        print(f"timing topk_select_pack body sweep, ({rows}, n), ms one-block/grid: {', '.join(line)}; "
              f"threshold in use {kt.small_row_max()}")


def bank_scatter(torch, kt):
    """``fn(vbank, vals, idx, W, n)`` -> (mixes, own images): the bank
    scatter, one launch; for ``kt`` without one (an earlier checkout's),
    what its device step did: one launch per mix and one P = 1 launch over
    a (P * n) buffer for the own images."""
    if hasattr(kt, "topk_scatter_accum_bank"):
        return kt.topk_scatter_accum_bank

    def two_launches(vbank, vals, idx, W, n):
        mixed = torch.stack([kt.topk_scatter_accum(vbank, idx, w, n) for w in W])
        peers = idx.shape[0]
        offset = torch.arange(peers, dtype=torch.int32, device=idx.device)[:, None] * n
        own = kt.topk_scatter_accum(vals.reshape(1, -1), (idx + offset).reshape(1, -1),
                                    torch.ones((1,), device=idx.device), peers * n)
        return mixed, own.view(peers, n)

    return two_launches


def scatter_timing(torch, kt):
    """The bank scatter as the mobilenet top-k + EF device step calls it (1
    mix + 4 own rows, the select's payload) at 240 (the median leaf),
    82,944 and 589,824 entries and at fc2/w, then one device step's 180
    bank scatters together; beside the plain version and the bound (bytes:
    ``COST.topk_scatter_cost``). ``kt`` without a bank scatter (an earlier checkout's)
    makes two launches a leaf, as its device step did. With both bodies
    (``scatter_launch``): each body forced over a sweep of row lengths, P
    = 4 banks and P = 1 rows (the cluster's decodes), the main path's k."""
    bank = bank_scatter(torch, kt)
    W = mixing_rows(torch, "full", PEERS)
    for n in (240, 82944, 589824, FC2):
        vbank, vals, idx = select_payload(torch, kt, n, PEERS, seed=n)
        k = idx.shape[1]
        iters = 10 if n == FC2 else 50
        plain = lambda: scatter_rows_plain(kt, vbank, vals, idx, W, n)
        t_plain1, _ = time_ms(torch, plain, iters)
        t_kern1, host1 = time_ms(torch, lambda: bank(vbank, vals, idx, W, n), iters)
        t_kern2, host2 = time_ms(torch, lambda: bank(vbank, vals, idx, W, n), iters)
        t_plain2, _ = time_ms(torch, plain, iters)
        nbytes = COST.topk_scatter_cost(PEERS, k, 1, n, own=True)[1]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"timing topk_scatter_accum bank ({PEERS}, {n}), k {k}, 1 mix + {PEERS} own rows: kernel "
              f"{t_kern1:.4f}/{t_kern2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.2f} MB at 3.35 TB/s; roofline share {bound / min(t_kern1, t_kern2):.1%}), "
              f"host enqueue {min(host1, host2) * 1e3:.1f} us/call")
    leaves = [select_payload(torch, kt, n, PEERS, seed=i) + (n,)
              for i, n in enumerate(mobilenet_leaf_sizes(torch))]
    step = lambda: [bank(vb, v, i, W, n) for vb, v, i, n in leaves]
    # one step: an earlier checkout's took ~70 ms to enqueue, and two would
    # outlast the spin kernel that keeps the device busy meanwhile
    t_step, host_step = time_ms(torch, step, 1)
    nbytes = sum(COST.topk_scatter_cost(PEERS, i.shape[1], 1, n, own=True)[1] for _, _, i, n in leaves)
    print(f"timing topk_scatter_accum, one mobilenet-v3-small device step's {len(leaves)} bank scatters "
          f"({PEERS} peers, 1 mix + {PEERS} own rows, "
          f"{len(leaves) * (1 if bank is getattr(kt, 'topk_scatter_accum_bank', None) else 2)} "
          f"launches): device {t_step:.4f} ms, host enqueue {host_step:.4f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB)")
    if hasattr(kt, "scatter_launch"):
        scatter_sweep(torch, kt)


SWEEP = {  # k as a fraction of n -> row lengths n of the body sweep
    1e-2: (8192, 32768, 82944, 131072, 262144, 409600, 589824, 786432, 1048576, 1572864, 2097152,
           3145728, 4194304),
    1e-3: (262144, 1048576, 2097152, 3145728, 4194304, 6291456, 8388608, 12582912, FC2),
    1e-4: (1048576, 4194304, 8388608, FC2),
}


def scatter_sweep(torch, kt):
    """Both bodies of the scatter (tiles, the long-row grid) at rows of n
    entries, k = 1 % of n (the main path's), 0.1 % (the benchmarks' lower
    fraction) and 0.01 %: (4, n) banks of 1 mix + 4 own rows, and P = 1
    rows of one mix (the cluster's decodes), and (4, n) banks of 4 ring
    mixes + 4 own rows. Each point gives both times, the tile body's reads
    (tiles x (M + 1 with own rows) x P x k pairs) and the body
    that ``scatter_body`` picks (T or L); the tile body's limits
    (``scatter_tile_pairs_max``, ``scatter_tile_reads_max``) are where it
    stops being the faster."""
    tile = kt.scatter_tile()
    for frac, sizes in SWEEP.items():
        for peers, own, graph in ((PEERS, True, "full"), (1, False, "full"), (PEERS, True, "ring")):
            W = mixing_rows(torch, graph, peers)
            mixes = W.shape[0]
            line, lost = [], 0.0
            for n in sizes:
                k = max(1, round(n * frac))
                vbank, vals, idx = select_payload(torch, kt, n, peers, seed=n, k=k)
                vals = vals if own else None
                times = [time_ms(torch, lambda b=b: kt.scatter_launch(vbank, vals, idx, W, n, b), 20)[0]
                         for b in (1, 2)]
                body = kt.scatter_body(mixes, peers, k, n, own)
                lost += times[body - 1] - min(times)
                reads = -(-n // tile) * (mixes + own) * peers * k
                line.append(f"{n} (k {k}, reads {reads}): {times[0]:.4f}/{times[1]:.4f} {'TL'[body - 1]}")
            print(f"timing topk_scatter_accum body sweep, k = {frac:g} n, ({peers}, n) {mixes} {graph} "
                  f"mix{'es' if mixes > 1 else ''}{' + own rows' if own else ''}, ms tile/long-row and "
                  f"the body picked: {', '.join(line)}; the pick loses {lost:.4f} ms over the sweep; "
                  f"tile {tile}, tile body up to {kt.scatter_tile_pairs_max()} pairs a block")


def ssd_timing(torch, ks):
    """The SSD kernel and its plain version (plain, kernel, kernel, plain)
    with bf16 inputs at the scoring shape and at one 32k sequence. Bound
    (the row's): the larger of the bytes (x, B, C in bf16, dt and A in f32
    read once, y in f32 written once) at 3.35 TB/s and the operations that
    the scan needs at least, those of the per-step recurrence, 4 B S H P N
    (a multiply-add into the state and one out of it per state element and
    step), at the bf16 tensor-core rate of 989.4 TFLOP/s, the rule of
    flash's bf16 row. The same count at the fp32 rate of 67 TFLOP/s (the
    bound of PRs 13-16, before the bf16 body ran on the tensor cores) is
    printed beside it, as is the chunked form's count (the causal half of
    both (Q, Q) products and 4QNP per (batch, head, chunk)). No single
    PyTorch call computes the scan."""
    out = {}
    for shape in (SSD_SCORING, SSD_LONG):
        Bsz, S_, H, P, G, N, Q = shape
        args = ssd_inputs(torch, shape, torch.bfloat16, seed=3)
        kern = lambda: ks.ssd_scan(*args, chunk=Q)
        plain = lambda: ks.ssd_scan_plain(*args, chunk=Q)
        iters, plain_iters = (20, 10) if shape == SSD_SCORING else (5, 3)
        t_plain1, _ = time_ms(torch, plain, plain_iters)
        t_kern1, host1 = time_ms(torch, kern, iters)
        t_kern2, host2 = time_ms(torch, kern, iters)
        t_plain2, _ = time_ms(torch, plain, plain_iters)
        ops, nbytes = COST.ssd_scan_cost(args[0], args[3])
        chunked_ops = Bsz * H * (-(-S_ // Q)) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
        fp32_ms = max(bytes_ms, ops / FP32_FLOPS * 1e3)
        row = {
            "ms": min(t_kern1, t_kern2),
            "plain_ms": min(t_plain1, t_plain2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        print(f"timing ssd_scan {shape[:4]} G={G} N={N} chunk {Q} bf16: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, "
              f"plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms:.4f} ms, recurrence {ops / 1e9:.2f} GFLOP at "
              f"989.4 TFLOP/s = {ops_ms:.4f} ms; roofline share {row['bound_ms'] / row['ms']:.1%}); fp32-rate "
              f"bound {fp32_ms:.4f} ms (at 67 TFLOP/s; share {fp32_ms / row['ms']:.1%}); the chunked form's "
              f"causal count {chunked_ops / 1e9:.2f} GFLOP; host enqueue {min(host1, host2) * 1e3:.1f} us/call, "
              f"library none: no single PyTorch call computes it")
        if shape == SSD_SCORING:
            out["ssd_scan"] = row
    return out


def flash_bound(torch, q, k, window: int, backward: bool = False, causal: bool = True):
    """(bound ms, bound_by, bytes, operations) of flash attention on these
    inputs, from the kernels' cost functions (``flash_attention_cost``,
    ``flash_attention_backward_cost``), over the valid (query, key) pairs
    that this call's mask keeps, not the whole Sq x Skv rectangle: causal,
    query i keeps min(i + 1, Skv, window) keys; not causal, all Sq x Skv
    pairs. At the dense bf16 tensor-core rate for bf16 inputs or the fp32
    rate for f32, against the bytes at 3.35 TB/s. Forward: q, k, v read and
    o written once, two products, 4 D H B operations a pair. ``backward``:
    q, k, v and do read and dq, dk, dv written once, the function's five
    products (s, dp, dv, dq, dk), 10 D H B operations a pair."""
    cost = COST.flash_attention_backward_cost if backward else COST.flash_attention_cost
    ops, nbytes = cost(q, k, causal=causal, window=window)
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops


def flash_timing(torch, kf):
    """The flash kernel as the scoring path calls it (under
    ``torch.inference_mode()``: nothing saved), the same launch writing o in
    f32 and lse for a backward as the train step calls it, and its plain
    version (plain, kernel, saving, saving, kernel, plain) at gemma2-2b's
    scoring shape in bf16 with softcap 50, for a local layer
    (window 4096) and a global one (no window); the global layer is the
    kernels line's row. Yardsticks the port never calls:
    ``flex_attention`` under ``torch.compile`` with the same tanh softcap
    as its ``score_mod`` and the causal (and window) mask as its block mask,
    which computes the same function, and ``scaled_dot_product_attention``
    (causal, GQA, no softcap, no window), a different function, printed
    only."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    from torch.nn.functional import scaled_dot_product_attention

    B, S_, H, K, D = FLASH_SCORING
    q, k, v = flash_inputs(torch, B, S_, S_, H, K, D, torch.bfloat16, seed=4)
    qt, kt_, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, D) views
    flex = torch.compile(flex_attention)
    score_mod = lambda score, b, h, qi, kj: torch.tanh(score / GEMMA_SOFTCAP) * GEMMA_SOFTCAP
    out = {}
    for window in (GEMMA_WINDOW, 0):
        def mask_mod(b, h, qi, kj, window=window):
            causal = qi >= kj
            return causal & (qi - kj < window) if window else causal

        t0 = time.perf_counter()
        block_mask = create_block_mask(mask_mod, None, None, S_, S_, device="cuda")
        lib = lambda: flex(qt, kt_, vt, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
        got = lib()
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        def kern():  # as the scoring path calls it: no statistics saved
            with torch.inference_mode():
                return kf.flash_attention(q, k, v, softcap=GEMMA_SOFTCAP, window=window)

        stats = lambda: kf.FlashAttentionFn.apply(q, k, v, True, GEMMA_SOFTCAP, window)
        plain = lambda: kf.flash_attention_plain(q, k, v, softcap=GEMMA_SOFTCAP, window=window)
        flex_err = float((got.transpose(1, 2).float() - kern().float()).abs().max())
        t_plain1, _ = time_ms(torch, plain, 3)
        t_kern1, host1 = time_ms(torch, kern, 10)
        t_stats1, _ = time_ms(torch, stats, 10)
        t_stats2, _ = time_ms(torch, stats, 10)
        t_kern2, host2 = time_ms(torch, kern, 10)
        t_plain2, _ = time_ms(torch, plain, 3)
        t_lib, _ = time_ms(torch, lib, 20)
        bound, by, nbytes, ops = flash_bound(torch, q, k, window)
        row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2), "bound_ms": bound,
               "bound_by": by, "library_ms": t_lib}
        print(f"timing flash_attention {FLASH_SCORING} bf16 softcap {GEMMA_SOFTCAP} window {window}: "
              f"kernel {t_kern1:.4f}/{t_kern2:.4f} ms (with o in f32 and lse saved for a backward, "
              f"as the train step calls it, {t_stats1:.4f}/{t_stats2:.4f} ms), plain "
              f"{t_plain1:.4f}/{t_plain2:.4f} ms, bound "
              f"{bound:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s, {nbytes / 1e6:.1f} MB at "
              f"3.35 TB/s; roofline share {bound / row['ms']:.1%}), host enqueue "
              f"{min(host1, host2) * 1e3:.1f} us/call, library flex_attention (torch.compile, first call "
              f"{compile_s:.1f} s) {t_lib:.4f} ms, max |flex - kernel| {flex_err:.3e}")
        out[window] = row
    t_sdpa, _ = time_ms(torch, lambda: scaled_dot_product_attention(
        qt, kt_, vt, is_causal=True, enable_gqa=True), 20)
    print(f"timing scaled_dot_product_attention {FLASH_SCORING} bf16, causal, GQA, no softcap and "
          f"no window (a different function, printed as a yardstick only): {t_sdpa:.4f} ms")
    return {"flash_attention": out[0]}


def time_flash_bwd(torch, kf, what: str, q, k, v, do, window: int):
    """The backward kernel (its two launches, from the o in f32 and lse that
    one forward launch saved first) and the plain backward (plain, kernel,
    kernel, plain) on these bf16 inputs with gemma2-2b's softcap, causal,
    with ``window``; printed beside its bound and, as a yardstick the port never
    calls, the backward of ``flex_attention`` under ``torch.compile`` with
    the same tanh ``score_mod`` and causal (and window) block mask, timed as
    ``torch.autograd.grad`` of its output with the graph retained (so with
    AOTAutograd's donated buffers off: a compiled backward that donates
    its saved tensors refuses ``retain_graph``). Returns the kernels
    line's timing keys."""
    import torch._functorch.config as aot_config

    with aot_config.patch(donated_buffer=False):
        return _time_flash_bwd(torch, kf, what, q, k, v, do, window)


def _time_flash_bwd(torch, kf, what: str, q, k, v, do, window: int):
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    S_ = q.shape[1]
    flex = torch.compile(flex_attention)
    score_mod = lambda score, b, h, qi, kj: torch.tanh(score / GEMMA_SOFTCAP) * GEMMA_SOFTCAP

    def mask_mod(b, h, qi, kj):
        causal = qi >= kj
        return causal & (qi - kj < window) if window else causal

    t0 = time.perf_counter()
    block_mask = create_block_mask(mask_mod, None, None, S_, S_, device="cuda")
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    o = flex(*leaves, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)
    lib = lambda: torch.autograd.grad(o, leaves, do.transpose(1, 2), retain_graph=True)
    got = lib()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    _, o32, lse = kf.FlashAttentionFn.apply(q, k, v, True, GEMMA_SOFTCAP, window)
    kern = lambda: kf.FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, True, GEMMA_SOFTCAP,
                                                     window)
    plain = lambda: kf.flash_attention_backward_plain(q, k, v, do, softcap=GEMMA_SOFTCAP,
                                                      window=window)
    flex_err = max(float((a.transpose(1, 2).float() - b.float()).abs().max())
                   for a, b in zip(got, kern()))
    del got
    many = S_ <= 2048  # short calls: more of them for the same time
    t_plain1, _ = time_ms(torch, plain, 10 if many else 2)
    t_kern1, host1 = time_ms(torch, kern, 20 if many else 5)
    t_kern2, host2 = time_ms(torch, kern, 20 if many else 5)
    t_plain2, _ = time_ms(torch, plain, 10 if many else 2)
    t_lib, _ = time_ms(torch, lib, 20 if many else 10)
    bound, by, nbytes, ops = flash_bound(torch, q, k, window, backward=True)
    row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2), "bound_ms": bound,
           "bound_by": by, "library_ms": t_lib}
    print(f"timing flash_attention_backward {what} {tuple(q.shape)} K={k.shape[2]} bf16 softcap "
          f"{GEMMA_SOFTCAP} window {window}: kernel {t_kern1:.4f}/{t_kern2:.4f} ms, plain "
          f"{t_plain1:.4f}/{t_plain2:.4f} ms, bound {bound:.4f} ms ({by}; {ops / 1e9:.2f} GFLOP at "
          f"989.4 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s; roofline share "
          f"{bound / row['ms']:.1%}; the kernels' 24 D operations a pair, S and dP three times "
          f"(delta's sweep, dq's, dk and dv's) and dq, dk and dv each from two bf16 halves of "
          f"its A operand, take {ops * 2.4 / BF16_FLOPS * 1e3:.4f} ms at that rate), host enqueue "
          f"{min(host1, host2) * 1e3:.1f} us/call, "
          f"library flex_attention backward (torch.compile, first forward and backward "
          f"{compile_s:.1f} s) {t_lib:.4f} ms, max |flex - kernel| {flex_err:.3e}")
    del o, leaves, o32, lse
    torch.cuda.empty_cache()
    return row


def slice_timing(torch, ks, kf):
    """The SSD and flash kernels at the hybrid and MoE paths' shapes, bf16,
    each beside its plain version, its bound and, for flash, the library
    call that computes the same function there (no softcap, no window):
    ``scaled_dot_product_attention``, causal, GQA. The SSD scan at
    zamba2-1.2b's scoring shape; the flash forward as zamba2's, granite's
    and moonshot's scoring forwards call it; the flash backward on
    granite's train shape, from one forward's saved statistics (SDPA's
    backward as its library call). Printed only: the kernels line keeps
    the rows of ``ssd_timing``, ``flash_timing`` and the train path."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    Bsz, S_, H, P, G, N, Q = SSD_ZAMBA
    args = ssd_inputs(torch, SSD_ZAMBA, torch.bfloat16, seed=3)
    t_plain, _ = time_ms(torch, lambda: ks.ssd_scan_plain(*args, chunk=Q), 5)
    t_kern, host = time_ms(torch, lambda: ks.ssd_scan(*args, chunk=Q), 20)
    ops, nbytes = COST.ssd_scan_cost(args[0], args[3])
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"timing ssd_scan {SSD_ZAMBA[:4]} G={G} N={N} chunk {Q} bf16 (zamba2-1.2b scoring): "
          f"kernel {t_kern:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms "
          f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; {nbytes / 1e6:.1f} MB at 3.35 TB/s "
          f"= {bytes_ms:.4f} ms, recurrence at 989.4 TFLOP/s = {ops_ms:.4f} ms; roofline share "
          f"{bound / t_kern:.1%}), host enqueue {host * 1e3:.1f} us/call, library none")
    del args
    bf16 = torch.bfloat16
    for what, (B, S_, H, K, D) in (("zamba2-1.2b scoring", (*SCORING_BATCH, 32, 32, 64)),
                                   ("granite-moe-3b-a800m scoring", (*SCORING_BATCH, 24, 8, 64)),
                                   ("moonshot-v1-16b-a3b scoring", (1, MOONSHOT_SEQ, 16, 16, 128))):
        q, k, v = flash_inputs(torch, B, S_, S_, H, K, D, bf16, seed=5)

        def kern():
            with torch.inference_mode():
                return kf.flash_attention(q, k, v)

        t_plain, _ = time_ms(torch, lambda: kf.flash_attention_plain(q, k, v), 3)
        t_kern, host = time_ms(torch, kern, 20)
        qt, kt_, vt = (t.transpose(1, 2) for t in (q, k, v))
        t_lib, _ = time_ms(torch, lambda: sdpa(qt, kt_, vt, is_causal=True, enable_gqa=True), 20)
        bound, by, nbytes, ops = flash_bound(torch, q, k, 0)
        print(f"timing flash_attention ({what}) {(B, S_, H, K, D)} bf16 causal: kernel "
              f"{t_kern:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s; roofline share {bound / t_kern:.1%}), host "
              f"enqueue {host * 1e3:.1f} us/call, library scaled_dot_product_attention {t_lib:.4f} ms")
        del q, k, v, qt, kt_, vt
    q, k, v, do = flash_bwd_inputs(torch, *GRANITE_FLASH, bf16, seed=5)
    _, o32, lse = kf.FlashAttentionFn.apply(q, k, v, True, 0.0, 0)
    kern = lambda: kf.FlashAttentionBackwardFn.apply(q, k, v, o32, lse, do, True, 0.0, 0)
    t_plain, _ = time_ms(torch, lambda: kf.flash_attention_backward_plain(q, k, v, do), 5)
    t_kern, host = time_ms(torch, kern, 20)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*leaves, is_causal=True, enable_gqa=True)
    t_lib, _ = time_ms(torch, lambda: torch.autograd.grad(o, leaves, do.transpose(1, 2),
                                                          retain_graph=True), 20)
    bound, by, nbytes, ops = flash_bound(torch, q, k, 0, backward=True)
    print(f"timing flash_attention_backward (granite-moe-3b-a800m train) {GRANITE_FLASH} bf16 "
          f"causal: kernel {t_kern:.4f} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms ({by}; "
          f"{ops / 1e9:.2f} GFLOP at 989.4 TFLOP/s; roofline share {bound / t_kern:.1%}), host "
          f"enqueue {host * 1e3:.1f} us/call, library scaled_dot_product_attention's backward "
          f"{t_lib:.4f} ms")
    del q, k, v, do, o32, lse, leaves, o
    torch.cuda.empty_cache()


def flash_bwd_timing(torch, kf):
    """``time_flash_bwd`` at gemma2-2b's scoring shape, its full context of
    8192, for a local layer (window 4096) and a global one: the shape the
    kernel check holds it at, beside the train path's own in
    ``check_flash_bwd_on_path``."""
    B, S_, H, K, D = FLASH_SCORING
    q, k, v, do = flash_bwd_inputs(torch, B, S_, S_, H, K, D, torch.bfloat16, seed=4)
    for window in (GEMMA_WINDOW, 0):
        time_flash_bwd(torch, kf, "at gemma2-2b's full context", q, k, v, do, window)


def reference_slice_lm_phase(torch):
    """``reference_lm_phase`` for the hybrid and MoE LMs: a 3-layer reduced
    zamba2-1.2b (a Mamba-2 layer, a layer applying the shared attention
    block, a Mamba-2 tail layer) through the SSD kernel, and a 3-layer
    reduced granite-moe-3b-a800m with the dense and with the capacity
    dispatch (prefill and decode take the dense one, the serve twin's)."""
    reference_lm_phase(torch, "zamba2-1.2b", 40, SSD_FLAGS)
    for dispatch in ("dense", "capacity"):
        reference_lm_phase(torch, "granite-moe-3b-a800m", 40, {"moe_dispatch": dispatch})


def profile_zamba(torch, zamba_run):
    """``profile_phase`` of zamba2-1.2b: a scoring forward must launch each
    of the SSD bf16 body's three passes once per Mamba-2 layer (32) and
    flash's bf16 body at D 64 once per shared_attn layer (6), neither f32
    body."""
    cfg = zamba_run[1]
    shared = sum(s.mixer == "shared_attn" for s in cfg.block_specs())
    bodies = {f"ssd {p}": cfg.num_layers - shared for p in ("states", "carry", "outputs")}
    bodies[f"wgmma<{cfg.resolved_head_dim}>"] = shared
    profile_phase(torch, "zamba2-1.2b", *zamba_run, SSD_FLAGS, bodies)


def select_timing_only(torch, src: Path) -> int:
    """``--select-timing SRC``: only ``select_timing`` and the mobilenet
    top-k + EF device step (with a profile of one step), with the
    ``repro_torch`` package under SRC (another checkout's ``src``, to time
    an earlier select on the same card); prints no result line."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import topk as kt

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks

    require(Path(kt.__file__).resolve().is_relative_to(src.resolve()), f"topk from {kt.__file__}")
    for mod in (kq, kt):
        mod.load_library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"nvidia-smi: {card_line()}; select of {kt.__file__}")
    select_timing(torch, kt)
    bank = hasattr(kt, "topk_select_pack_bank")
    drive_step(torch, {"kq": kq, "kt": kt, "ks": ks, "kf": kf}, "mobilenet-v3-small", 4,
               exchange="topk", selects_per_leaf=1 if bank else PEERS, profile=True)
    return 0


def scatter_timing_only(torch, src: Path) -> int:
    """``--scatter-timing SRC``: only the scatter's row of ``timing_phase``
    (with its ``index_add_`` yardstick), ``scatter_timing`` and the
    mobilenet top-k + EF device step (with a profile of one step), with the
    ``repro_torch`` under SRC (another checkout's ``src``, to time an
    earlier scatter on the same card); prints no result line."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import topk as kt

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks

    require(Path(kt.__file__).resolve().is_relative_to(src.resolve()), f"topk from {kt.__file__}")
    for mod in (kq, kt):
        mod.load_library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"nvidia-smi: {card_line()}; scatter of {kt.__file__}")
    timing_phase(torch, kq, kt, only="topk_scatter_accum")
    scatter_timing(torch, kt)
    bank = hasattr(kt, "topk_scatter_accum_bank")
    drive_step(torch, {"kq": kq, "kt": kt, "ks": ks, "kf": kf}, "mobilenet-v3-small", 4,
               exchange="topk", scatters_per_leaf=1 if bank else 2, profile=True)
    return 0


def zamba2_kernels_only(torch) -> int:
    """``--zamba2-kernels``: only ``zamba2_kernel_phase``, printing its
    rows; prints no result line."""
    from repro_torch.kernels import build
    from repro_torch.kernels import causal_conv as kc
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ssd_scan as ks

    build.build_all([ks.SOURCE, ks.BWD_SOURCE, kf.SOURCE, kf.BWD_SOURCE, kc.SOURCE])
    for mod in (ks, kf, kc):
        mod.load_library()
    print(f"nvidia-smi: {card_line()}")
    errs, rows = zamba2_kernel_phase(torch, ks, kf, kc)
    print(json.dumps({"zamba2_7b": {name: dict(rows[name], max_abs_err=errs[name]) for name in rows}}))
    return 0


def ssd_timing_only(torch, src: Path) -> int:
    """``--ssd-timing SRC``: only ``ssd_timing``, with the ``repro_torch``
    package under SRC (another checkout's ``src``, to time an earlier SSD
    kernel on the same card); prints no result line."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import ssd_scan as ks

    require(Path(ks.__file__).resolve().is_relative_to(src.resolve()), f"ssd_scan from {ks.__file__}")
    ks.load_library()
    print(f"nvidia-smi: {card_line()}; SSD scan of {ks.__file__}")
    ssd_timing(torch, ks)
    return 0


def p2p_runs(torch):
    """The P2P paths that hold params once (clusters and device steps), as
    ``(drive function, arch, epochs or steps, options)``."""
    return (
        (drive, "mobilenet-v3-small", 3, dict(graph="full")),
        (drive, "vgg11", 2, dict(graph="full")),
        (drive, "mobilenet-v3-small", 1, dict(graph="ring", ef=True)),
        (drive, "mobilenet-v3-small", 1, dict(exchange="topk", ef=True)),
        (drive_step, "vgg11", 4, dict(exchange="qsgd")),
        (drive_step, "mobilenet-v3-small", 4, dict(exchange="topk")),
        (drive, "mobilenet-v3-small", 2, dict(batches=16, priced=True)),
        (drive_async, "mobilenet-v3-small", 2, {}),
        # robust, sharded and tree exchange
        (drive, "mobilenet-v3-small", 2, dict(exchange="trimmed_mean:0.25", adversary=ADV_SIGN,
                                              check=poisoned(2))),
        (drive, "mobilenet-v3-small", 2, dict(exchange="median", graph="ring", adversary=ADV_NOISE,
                                              reject_nonfinite=True, check=poisoned(2))),
        (drive, "vgg11", 2, dict(exchange="krum", adversary=ADV_NOISE,
                                 check=krum_excludes_the_attacker(torch))),
        (drive, "vgg11", 2, dict(exchange="reduce_scatter", priced=True,
                                 check=sharded_checks(torch, "vgg11", 2, 1, True))),
        (drive, "mobilenet-v3-small", 2, dict(exchange="tree:2", priced=True,
                                              check=sharded_checks(torch, "mobilenet-v3-small", 2,
                                                                   2, False))),
        (drive, "mobilenet-v3-small", 2, dict(adversary=ADV_STALE, check=poisoned(1))),
        (drive_robust_step, "vgg11", 4, dict(exchange="reduce_scatter", rail=True)),
        (drive_robust_step, "vgg11", 4, dict(exchange="tree", rail=True)),
        (drive_robust_step, "vgg11", 4, dict(exchange="trimmed_mean:0.25", adversary=ADV_SIGN,
                                             profile=True)),
        (drive_robust_step, "vgg11", 4, dict(exchange="krum", adversary=ADV_NOISE)),
    )


def p2p_timing_only(torch, src: Path) -> int:
    """``--p2p-timing SRC``: only the paths of ``p2p_runs`` (without their
    checks: an earlier checkout's card runs do not repeat themselves), with
    the ``repro_torch`` under SRC and cuDNN TF32 off globally, as the
    script set it before the port chose its own CNN numerics; run it for
    an earlier checkout and this one in one call to compare their epochs
    and steps on one card. Prints no result line."""
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels import topk as kt

    require(Path(kq.__file__).resolve().is_relative_to(src.resolve()), f"qsgd from {kq.__file__}")
    for mod in (kq, kt):
        mod.load_library()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"nvidia-smi: {card_line()}; P2P paths of {Path(kq.__file__).parents[2]}")
    mods = {"kq": kq, "kt": kt, "ks": ks, "kf": kf}
    start = time.perf_counter()
    for fn, arch, length, kw in p2p_runs(torch):
        fn(torch, mods, arch, length, **{k: v for k, v in kw.items() if k != "check"})
    print(f"P2P paths of {src}: {time.perf_counter() - start:.1f} s")
    return 0


def train_timing_only(torch, src: Path) -> int:
    """``--train-timing SRC``: only the train paths' steps, with the
    ``repro_torch`` under SRC, in the allocator mode that
    ``PYTORCH_CUDA_ALLOC_CONF`` gives the process (fixed segments unless it
    says ``expandable_segments:True``; a port that switches the allocator
    when it builds its step is switched back): mamba2-370m at 2 peers x
    1024 tokens for 6 steps, gemma2-2b from 2 x TRAIN_SEQ down the cuts for
    4 steps, and gemma2-2b at 2 x 512 (where every checkout fits) for 4
    steps. Run it for an earlier checkout and this one, in both modes, in
    one call to compare their steps on one card. Prints no result line."""
    sys.path.insert(0, str(src.resolve()))
    import repro_torch.train as train
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels import topk as kt
    from repro_torch.optim import constant

    require(Path(train.__file__).resolve().is_relative_to(src.resolve()), f"train from {train.__file__}")
    expandable = "expandable_segments:True" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")
    build_step = train.build_train_step

    def build_in_mode(*args, **kw):
        step = build_step(*args, **kw)
        torch._C._accelerator_setAllocatorSettings(f"expandable_segments:{expandable}")
        return step

    train.build_train_step = build_in_mode
    kf.load_library()
    print(f"nvidia-smi: {card_line()}; train paths of {Path(train.__file__).parents[2]}, "
          f"{'expandable' if expandable else 'fixed'} segments")
    mods = {"kq": kq, "kt": kt, "ks": ks, "kf": kf}
    start = time.perf_counter()
    drive_train(torch, mods, "mamba2-370m", steps=6, schedule=constant(TRAIN_LR),
                cuts=((TRAIN_PEERS, 1024),), check_launches=False)
    release(torch)
    drive_train(torch, mods, "gemma2-2b", cuts=CUTS, check_launches=False)
    release(torch)
    drive_train(torch, mods, "gemma2-2b", cuts=((TRAIN_PEERS, 512),), check_launches=False)
    release(torch)
    print(f"train paths of {src}: {time.perf_counter() - start:.1f} s")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--select-timing"]:
        return select_timing_only(torch, Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ssd-timing"]:
        return ssd_timing_only(torch, Path(sys.argv[2]))
    if sys.argv[1:2] == ["--scatter-timing"]:
        return scatter_timing_only(torch, Path(sys.argv[2]))
    if sys.argv[1:2] == ["--p2p-timing"]:
        return p2p_timing_only(torch, Path(sys.argv[2]))
    if sys.argv[1:2] == ["--train-timing"]:
        return train_timing_only(torch, Path(sys.argv[2]))
    if sys.argv[1:2] == ["--zamba2-kernels"]:
        return zamba2_kernels_only(torch)
    from repro_torch.kernels import build
    from repro_torch.kernels import causal_conv as kc
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels import topk as kt

    mods = {"kq": kq, "kt": kt, "ks": ks, "kf": kf, "kc": kc}
    start = time.perf_counter()
    stamp = lambda what: print(f"[{time.perf_counter() - start:.1f} s] {what} done", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(f"PyTorch's global flags, left as they are: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cudnn.deterministic={torch.backends.cudnn.deterministic} "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    card = card_line()
    print(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all([kq.SOURCE, kt.SOURCE, ks.SOURCE, ks.BWD_SOURCE, kf.SOURCE, kf.BWD_SOURCE,
                            kc.SOURCE])
    for mod in (kq, kt, ks, kf, kc):
        mod.load_library()
    print(f"build: {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s")
    print_ptxas(kf.BWD_SOURCE, build.ptxas_report(kf.BWD_SOURCE))

    checks = kernel_phase(torch, kq)
    errs = {name: checks[name][0] for name in checks}
    errs.update(new_kernel_phase(torch, kq, kt))
    errs["ssd_scan"] = ssd_kernel_phase(torch, ks)
    errs["flash_attention"] = flash_kernel_phase(torch, kf)
    errs["flash_attention_backward"] = flash_bwd_phase(torch, kf)
    ssd_grad_errs, ssd_grad_rows = ssd_grad_phase(torch, ks)
    errs.update(ssd_grad_errs)
    conv_errs, conv_rows = conv_phase(torch, kc, CONV_MAMBA2, "mamba2-370m's train cell",
                                      MAMBA_LAYERS)
    errs.update(conv_errs)
    zamba2_errs, zamba2_rows = zamba2_kernel_phase(torch, ks, kf, kc)
    grad_guard_phase(torch, kf, ks)
    stamp("kernels phase")
    reference_phase(torch)
    reference_step_phase(torch)
    reference_async_phase(torch)
    robust_reference_phase(torch)
    reference_bank_phase(torch)
    determinism_phase(torch, mods)
    reference_lm_phase(torch, "mamba2-370m", 40, SSD_FLAGS)
    reference_lm_phase(torch, "gemma2-2b", 160, {})  # 160 > the window of 64
    reference_slice_lm_phase(torch)
    for arch in ("whisper-base", "internvl2-26b"):  # frames and patches (stub_inputs)
        reference_lm_phase(torch, arch, 40, {})
    stamp("reference phase")

    total = dict.fromkeys(KERNELS, 0)
    runs = p2p_runs(torch) + (
        # the per-peer bank (sparse overlays, async)
        (drive_bank_step, "vgg11", 4, dict(exchange="qsgd", graph="ring", ef=True)),
        (drive_bank_step, "mobilenet-v3-small", 4, dict(exchange="topk", graph="hierarchical:2",
                                                        ef=True)),
        (drive_bank_step, "vgg11", 4, dict(exchange="async", staleness=2)),
        (drive_bank_step, "vgg11", 4, dict(exchange="trimmed_mean:0.34", graph="ring",
                                           adversary=ADV_SIGN)),
    )
    for fn, arch, length, kw in runs:
        for name, count in fn(torch, mods, arch, length, **kw).items():
            total[name] += count
    stamp("P2P paths")
    lm_counts, lm_err, lm_run = drive_lm(torch, mods)
    errs["ssd_scan"] = max(errs["ssd_scan"], lm_err)
    stamp("mamba2-370m path")
    gemma_counts, gemma_err, gemma_run = drive_gemma(torch, mods)
    errs["flash_attention"] = max(errs["flash_attention"], gemma_err)
    stamp("gemma2-2b path")
    zamba_counts, zamba_ssd_err, zamba_flash_err, zamba_run = drive_zamba(torch, mods)
    errs["ssd_scan"] = max(errs["ssd_scan"], zamba_ssd_err)
    errs["flash_attention"] = max(errs["flash_attention"], zamba_flash_err)
    stamp("zamba2-1.2b path")
    granite_counts, granite_err = drive_granite(torch, mods)
    errs["flash_attention"] = max(errs["flash_attention"], granite_err)
    stamp("granite-moe-3b-a800m path")
    whisper_counts, whisper_err = drive_whisper(torch, mods)
    errs["flash_attention"] = max(errs["flash_attention"], whisper_err)
    stamp("whisper-base path")
    for counts in (lm_counts, gemma_counts, zamba_counts, granite_counts, whisper_counts):
        for name, count in counts.items():
            total[name] += count

    times = timing_phase(torch, kq, kt)
    times.update(select_timing(torch, kt))
    scatter_timing(torch, kt)
    times.update(ssd_timing(torch, ks))
    times.update(ssd_grad_rows)
    times.update(conv_rows)
    times.update(flash_timing(torch, kf))
    flash_bwd_timing(torch, kf)
    slice_timing(torch, ks, kf)
    whisper_timing(torch, kf)
    estimator_timing(torch)
    bank_grad_timing(torch)
    stamp("timing phase")
    mamba_cfg = lm_run[1]  # every layer's scan: the three passes of the bf16 body, no f32 body
    profile_phase(torch, "mamba2-370m", *lm_run, SSD_FLAGS,
                  {f"ssd {p}": mamba_cfg.num_layers for p in ("states", "carry", "outputs")})
    gemma_cfg = gemma_run[1]  # every layer's scoring attention: the bf16 body at its headdim
    profile_phase(torch, "gemma2-2b", *gemma_run, {},
                  {f"wgmma<{gemma_cfg.resolved_head_dim}>": gemma_cfg.num_layers})
    profile_zamba(torch, zamba_run)
    stamp("profile phase")
    del lm_run, gemma_run, zamba_run  # the serving models: the next paths need the card's memory
    release(torch)
    moon_counts, moon_err = drive_moonshot(torch, mods)
    errs["flash_attention"] = max(errs["flash_attention"], moon_err)
    stamp("moonshot-v1-16b-a3b path")
    vlm_counts, vlm_err = drive_internvl2(torch, mods)
    errs["flash_attention"] = max(errs["flash_attention"], vlm_err)
    stamp("internvl2-26b path")
    # the first train step built switches the allocator to expandable
    # segments (build_train_step): every phase above ran on fixed ones
    reference_train_phase(torch)
    remat_phase(torch, mods)
    stamp("reference train phase")
    train_counts, (train_cfg, peers, seq) = drive_train(torch, mods, "gemma2-2b", dryrun=True)
    release(torch)
    path_err, times["flash_attention_backward"] = check_flash_bwd_on_path(torch, mods, train_cfg,
                                                                          peers, seq)
    errs["flash_attention_backward"] = max(errs["flash_attention_backward"], path_err)
    stamp("gemma2-2b train path")
    release(torch)
    mamba_train_counts = drive_mamba_train(torch, mods)
    stamp("mamba2-370m train path")
    cli_counts, cli_err = drive_cli_train(torch, mods)
    errs["flash_attention_backward"] = max(errs["flash_attention_backward"], cli_err)
    stamp("qwen2.5-3b train CLI path")
    ckpt_counts = drive_cli_checkpoint(torch, mods)
    example_counts = drive_example(torch, mods)
    drive_serve_decode(torch, mods)
    stamp("checkpoint and example paths")
    slice_counts = []
    for arch in ("zamba2-1.2b", "granite-moe-3b-a800m"):
        counts, err = drive_slice_train(torch, mods, arch)
        errs["flash_attention_backward"] = max(errs["flash_attention_backward"], err)
        slice_counts.append(counts)
        release(torch)
        stamp(f"{arch} train path")
    granite_cli_rate(torch)
    stamp("granite-moe-3b-a800m at the CLI's rate")
    whisper_train_counts, err = drive_whisper_train(torch, mods)
    errs["flash_attention_backward"] = max(errs["flash_attention_backward"], err)
    stamp("whisper-base train path")
    dryrun_phase(torch)
    stamp("dryrun phase")
    for counts in (moon_counts, vlm_counts, train_counts, mamba_train_counts, cli_counts, ckpt_counts,
                   example_counts, *slice_counts, whisper_train_counts):
        for name, count in counts.items():
            total[name] += count
    require(all(total.values()), f"a kernel was never launched on the main path: {total}")
    for name, row in zamba2_rows.items():  # the zamba2-7b cell's shapes, held and timed apart
        times[name]["zamba2_7b"] = dict(row, max_abs_err=zamba2_errs[name])
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": total[name],
            "max_abs_err": errs[name],
            **times[name],
        }
        for name, (_, source, replaces) in KERNELS.items()
    ]
    print(f"nvidia-smi: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, no arguments
    python3 chip_smoke.py --select-timing SRC   # the select alone (below)
    python3 chip_smoke.py --scatter-timing SRC  # the scatter alone (below)
    python3 chip_smoke.py --ssd-timing SRC      # the SSD scan alone (below)

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
             and at chunk 16 with N = 8; flash attention at gemma2-2b's
             scoring shape (1, 8192, 8 heads over 4, D 256), softcap 50,
             window 4096 and none, in bf16 (the tensor-core body), the same
             at S = 1024 in f32 (the CUDA-core body), and in both types a
             ragged S = 1000, Sq 300 against Skv 500 without causal
             masking, D 32, 64 and 128, and MHA (32 heads, D 64); in bf16
             also Sq 200 with a window of 40, D 96, 160, 192 and 224, and q,
             k, v as strided views of one fused projection. The flash and
             SSD wrappers refuse grad mode (an input requiring grad) with
             no launch, and launch under ``torch.inference_mode()``.
3. reference — small runs on the card against the same runs on the CPU
             (plain versions), same init and uniforms: a 4-peer squeezenet
             QSGD cluster epoch, one device train step with qsgd + EF and
             with topk + EF, the reference's churned async cluster scenario
             (2 squeezenet peers, churn 0.3, ``sim_compute_s`` pinned, 2
             epochs: equal trace digests, params within 1e-5), 2 epochs
             of 4 squeezenet peers with ``trimmed_mean:0.25`` and a
             sign_flip attacker and with ``reduce_scatter`` (params within
             1e-5, 1e-4 where the trim keeps the attacker's row), a 3-layer
             reduced mamba2 and a 3-layer reduced gemma2 (S 160 over its
             window of 64) in f32 (forward, prefill logits and states or
             caches, 8 greedy decode steps).
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
             attacker; these launch none of the kernels.
             mamba2-370m at full width (48 layers, bf16): the scoring
             ``forward(..., use_ssd_kernel=True)`` on 4 x 2048 tokens (48
             SSD launches each) and the serve twin's prefill of 4 x 512
             and 32 greedy tokens (no SSD launch, as in the reference).
             gemma2-2b at full width (26 layers, bf16): the scoring
             ``forward`` on 1 x 8192 tokens (26 flash launches each), the serve twin at batch 4 with a
             512-token prompt and 32 greedy tokens, and at batch 1 with a
             6144-token prompt (the local layers' 4096-token caches roll)
             and 16 tokens (26 flash launches in each prefill, none in
             decode). Launch counters are zeroed before and read after each
             run and must equal the counts the path implies. Then the SSD
             kernel is held to its plain version on one layer's own inputs
             from a scoring forward, and the flash kernel on a global and
             a local layer's; those forwards' launches, and those of the
             prefill-vs-forward checks, stay out of the kernels line.
5. timing  — each kernel, its plain version, the PyTorch call that computes
             the same function where there is one, and the bound, at the
             main path's largest shapes, timed with CUDA events; the select
             also at (4, n) banks, over one mobilenet device step's 180
             bank selects, and both its bodies over a sweep of row lengths;
             the scatter beside ``index_add_`` at fc2/w, at the device
             step's (1 mix + 4 own rows) banks, over one step's 180 bank
             scatters, and both its bodies over a sweep of row lengths;
             the SSD scan also at one 32k sequence, beside the bf16 bound
             and the fp32-rate bound of earlier rows; the robust
             estimators (trimmed mean, median, Krum's Gram matrix and
             selection) and the ``reduce_scatter`` and ``tree:2`` combines
             on a (4, vgg11's 28.1 M) f32 bank beside their byte bounds.
6. profile — ``torch.profiler`` over one scoring forward and 4 decode
             steps of mamba2-370m and of gemma2-2b: the device's busy and
             idle share and kernel time by kind (SSD or flash kernel,
             matrix products, the rest), and the flash and SSD launches by
             body: a gemma2-2b forward must launch flash's bf16 body once
             per layer and its f32 body never, a mamba2-370m forward each
             of the SSD bf16 body's three passes once per layer and its f32
             body never. Each profile runs its work twice and reads the
             second run only (the profiler can lose the device records of
             a session's first launches); a profile that still lost the
             device record of a launch it recorded on the host is taken
             again, at most three times in all; the last one is held to the
             rule.

The last two lines of stdout are a ``{"kernels": [...]}`` JSON line and the
result ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.

``--ssd-timing SRC`` runs only the SSD kernel's timing, likewise with the
``repro_torch`` under SRC; it prints no result line.

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
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
BF16_FLOPS = 989.4e12  # H100 SXM dense bf16 on the tensor cores (data sheet)
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
}
SSD_SCORING = (4, 2048, 32, 64, 1, 128, 256)  # B, S, H, P, G, N, chunk of mamba2-370m scoring
SSD_LONG = (1, 32768, 32, 64, 1, 128, 256)  # one 32k sequence
PROMPT, GEN = 512, 32  # the serve path
FLASH_SCORING = (1, 8192, 8, 4, 256)  # B, S, H, K, D of gemma2-2b scoring: its full context
GEMMA_WINDOW, GEMMA_SOFTCAP = 4096, 50.0  # the local layers' window, the attention softcap
LONG_PROMPT, LONG_GEN = 6144, 16  # a prompt past the window: the local caches roll
SSD_FLAGS = {"use_ssd_kernel": True}  # mamba2's scoring forward through the SSD kernel


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
    return getattr(mods[KERNELS[name][0]], name)


def reset_counters(mods) -> None:
    for name in KERNELS:
        wrapper(mods, name).launches = 0


def read_counters(mods) -> dict:
    return {name: wrapper(mods, name).launches for name in KERNELS}


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
    sums, the max abs error within 2e-5 of max|y|."""
    worst = 0.0
    cases = ((SSD_SCORING, torch.bfloat16), (SSD_SCORING, torch.float32),
             ((1, 80, 8, 32, 4, 16, 32), torch.float32),  # padded last chunk, 4 groups
             ((2, 64, 4, 64, 1, 32, 64), torch.float32),  # a single chunk
             (SSD_LONG, torch.bfloat16),
             ((1, 80, 8, 32, 4, 16, 32), torch.bfloat16),
             ((2, 64, 4, 64, 1, 32, 64), torch.bfloat16),
             ((1, 32, 2, 16, 1, 8, 16), torch.bfloat16))  # chunk 16 under a 64-row tile, N 8
    for shape, dtype in cases:
        args = ssd_inputs(torch, shape, dtype, seed=shape[1])
        y = ks.ssd_scan(*args, chunk=shape[-1])
        ref = ks.ssd_scan_plain(*args, chunk=shape[-1])
        torch.cuda.synchronize()
        require(y.shape == ref.shape == shape[:4] and y.dtype == torch.float32,
                f"ssd_scan output {tuple(y.shape)} {y.dtype} at {shape}")
        err = (y - ref).abs()
        scale = float(ref.abs().max())
        if shape in (SSD_SCORING, SSD_LONG):
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


def planted_faults(torch, kf, q, k, v, *, causal, softcap, window):
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
                              window=w if causal else 0, softcap_val=softcap).to(q.dtype)


def check_flash(torch, kf, q, k, v, what, *, causal=True, softcap=0.0, window=0, faults=None):
    """The flash kernel against its plain version on the same inputs, within
    ``flash_tolerance``. ``faults="require"``: each of ``planted_faults``
    must fall outside that limit; ``"report"``: print how far outside.
    Returns the largest abs error."""
    out = kf.flash_attention(q, k, v, causal=causal, softcap=softcap, window=window)
    ref = kf.flash_attention_plain(*(t.float() for t in (q, k, v)), causal=causal, softcap=softcap,
                                   window=window)
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
                                        window=window):
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
    CUDA-core one; every case below S 8192 runs in both, and the bf16 body
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
    """The LM kernels have no backward on the card yet (ROADMAP Queue 1
    item 16). With grad mode on and an input that requires grad, each
    wrapper raises RuntimeError before any launch (its counter unchanged);
    the same call under ``torch.inference_mode()`` launches once."""
    q, k, v = flash_inputs(torch, 1, 256, 256, 4, 2, 64, torch.bfloat16, seed=11)
    ssd = ssd_inputs(torch, (1, 64, 4, 32, 1, 16, 32), torch.float32, seed=11)
    for fn, args, kw in ((kf.flash_attention, (q, k, v), {}), (ks.ssd_scan, ssd, {"chunk": 32})):
        name = fn.__name__
        args = (args[0].detach().requires_grad_(True), *args[1:])
        before = fn.launches
        try:
            fn(*args, **kw)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        torch.cuda.synchronize()
        require("Queue 1 item 16" in refused, f"{name} under grad mode did not refuse: {refused!r}")
        require(fn.launches == before, f"{name} launched before refusing grad mode")
        with torch.inference_mode():
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        require(fn.launches == before + 1 and bool(torch.isfinite(out).all()),
                f"{name} under inference_mode: {fn.launches - before} launches")
        print(f"kernel check {name} with an input requiring grad: RuntimeError under grad mode "
              f"with no launch; one launch under inference_mode")


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
    + EF) of 726,474 params beyond 1e-5, and 0 in another run of the same
    topk steps. ``tests/test_torch_p2p.py`` holds 3 steps of both to the
    reference on the CPU, where the two sides' gradients are closer."""
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


def reference_lm_phase(torch, arch: str, seq: int, flags: dict):
    """A 3-layer reduced ``arch`` in f32, the same weights (one CPU
    generator seed) on the card and on the CPU: the forward with ``flags``
    (the CPU takes the kernels' plain versions), prefill logits and every layer's state (SSM and convolution
    states, or the K/V cache), then 8 greedy decode steps. Logits within
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
    runs = {}
    for device, model in (("cpu", cpu_model), ("cuda", copy.deepcopy(cpu_model).to("cuda"))):
        model.requires_grad_(False)
        with torch.inference_mode():
            logits, _ = models.forward(model, {"tokens": tokens}, cfg, **flags)
            _, state = models.prefill(model, models.init_decode_state(cfg, 2, seq + 9, device=device),
                                      {"tokens": tokens}, cfg)
        res = serve.generate(model, cfg, tokens.to(device), 9)  # prefill, then 8 decode steps
        runs[device] = (logits.cpu(), dict(res, state=state))
    (lc, rc), (lg, rg) = runs["cpu"], runs["cuda"]
    close = lambda a, b, tol: bool(torch.all((a.cpu() - b.cpu()).abs() <= tol + tol * b.cpu().abs()))
    tag = f"reduced {arch}"
    require(close(lg, lc, 1e-4), f"{tag} forward: card vs CPU logits beyond 1e-4")
    require(close(rg["prefill_logits"], rc["prefill_logits"], 1e-4),
            f"{tag} prefill: card vs CPU logits beyond 1e-4")
    for layer, (sg, sc) in enumerate(zip(rg["state"]["layers"], rc["state"]["layers"])):
        for k in sc:
            require(close(sg[k], sc[k], 1e-5), f"{tag} layer {layer} {k} state beyond 1e-5")
    require((rg["tokens"] == rc["tokens"]).all(), f"{tag}: greedy tokens differ, card vs CPU")
    err = float((lg - lc).abs().max())
    print(f"reference check ({tag}, 3 layers, f32, {seq} tokens, card with "
          f"{flags or 'the flash kernel'} vs CPU): "
          f"forward logits max_abs_err={err:.3e}, prefill logits "
          f"{float((rg['prefill_logits'].cpu() - rc['prefill_logits']).abs().max()):.3e}, "
          f"states of {sorted(rc['state']['layers'][0])} within 1e-5, "
          f"8 greedy decode steps identical: {rg['tokens'][0].tolist()}")


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
    launches are read; the peers' params after epoch 0 are kept for it as
    ``cluster.first_epoch_params``."""
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
    if check is not None:
        run_epoch = cluster.run_epoch_sync

        def keep_first(epoch):
            out = run_epoch(epoch)
            if epoch == 0:
                cluster.first_epoch_params = [dict(p.params) for p in cluster.peers]
            return out

        cluster.run_epoch_sync = keep_first
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
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import QSGDConfig, Topology, TrainState, build_p2p_train_step
    from repro_torch.core.simulate import cnn_loss
    from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro_torch.optim import sgd

    ds = make_dataset("cifar")
    cfg = dataclasses.replace(get_config(arch), image_size=ds.image_hw,
                              image_channels=ds.channels, num_classes=ds.num_classes)
    topo = Topology(exchange=exchange, qsgd=QSGDConfig(S, BUCKET), topk_frac=TOPK_FRAC, ef=True)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, PEERS * 32)
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)
    params = {k: v.clone() for k, v in model.named_parameters()}
    opt = sgd(momentum=0.9)
    step = build_p2p_train_step(lambda p, b: cnn_loss(model, p, b["images"], b["labels"]),
                                opt, topo, PEERS, lambda s: 0.01)
    state = TrainState(params, opt.init(params), 0, torch.Generator(device="cuda").manual_seed(0))
    batches = []
    for i in range(steps):
        b = loader.load(BatchKey(0, 0, i))
        batches.append({"images": models.images_to_device(b["images"], "cuda"),
                        "labels": torch.from_numpy(b["labels"].astype(np.int64)).cuda()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses, marks = [], []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))  # waits for the step
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
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
    plan would be larger); and params after epoch 0 within 1e-6 of an
    ``allgather_mean`` epoch from the same seed on the card. One epoch,
    because the card's backward is not bit-reproducible from run to run
    (some of PyTorch's CUDA backward kernels add with atomics), and later
    epochs compound that drift: the check prints the gap after the last
    epoch beside the gap between two ``allgather_mean`` runs."""
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
        base.run_epoch_sync(0)
        gap = params_gap(cluster.first_epoch_params, [p.params for p in base.peers])
        require(gap <= 1e-6, f"{tag}: epoch-0 params {gap:.3e} from allgather_mean's, above 1e-6")
        print(f"  epoch-0 params within {gap:.3e} of an allgather_mean epoch from the same seed "
              f"(rail 1e-6)")
        again = LocalP2PCluster(
            get_config(arch), make_dataset("cifar"), num_peers=PEERS, batch_size=32,
            batches_per_epoch=2, optimizer=sgd(momentum=0.9), lr=0.01,
            exchange="allgather_mean", seed=0,
        )
        for e in range(epochs):
            again.run_epoch_sync(e)
            if e:
                base.run_epoch_sync(e)
        final = [p.params for p in cluster.peers]
        print(f"  after {epochs} epochs (not held): {params_gap(final, [p.params for p in base.peers]):.3e} "
              f"from allgather_mean's; two allgather_mean runs "
              f"{params_gap([p.params for p in again.peers], [p.params for p in base.peers]):.3e} apart")
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
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import AdversarySpec, Topology, TrainState, build_p2p_train_step
    from repro_torch.core.simulate import cnn_loss
    from repro_torch.data import BatchKey, DataLoader, Partitioner, make_dataset
    from repro_torch.optim import sgd

    ds = make_dataset("cifar")
    cfg = dataclasses.replace(get_config(arch), image_size=ds.image_hw,
                              image_channels=ds.channels, num_classes=ds.num_classes)
    loader = DataLoader(Partitioner(ds, 1, shuffle_seed=0), 0, PEERS * 32)
    adv = None if adversary is None else AdversarySpec(**adversary)
    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)
    params = {k: v.clone() for k, v in model.named_parameters()}
    loss_fn = lambda p, b: cnn_loss(model, p, b["images"], b["labels"])
    opt = sgd(momentum=0.9)
    step = build_p2p_train_step(loss_fn, opt, Topology(exchange=exchange), PEERS,
                                lambda s: 0.01, adversary=adv)
    state = TrainState(params, opt.init(params), 0, torch.Generator(device="cuda").manual_seed(0))
    batches = []
    for i in range(steps):
        b = loader.load(BatchKey(0, 0, i))
        batches.append({"images": models.images_to_device(b["images"], "cuda"),
                        "labels": torch.from_numpy(b["labels"].astype(np.int64)).cuda()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses, marks, first = [], [], None
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))  # waits for the step
        marks.append(time.perf_counter())
        first = first or state.params
    torch.cuda.synchronize()
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
        gap = max(float((first[k] - ref.params[k]).abs().max()) for k in params)
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
    CUDA cores); the SSD kernel's bf16 passes "ssd states", "ssd carry" and
    "ssd outputs", or its f32 body "ssd f32"."""
    if "flash_attention_kernel_wgmma<" in name:
        return "wgmma<" + name.split("flash_attention_kernel_wgmma<", 1)[1].split(">", 1)[0] + ">"
    if "flash_attention_kernel<" in name:
        return "f32"
    found = re.search(r"\bssd_kernel_(states|carry|outputs)\b", name)
    if found:
        return "ssd " + found.group(1)
    return "ssd f32" if "ssd_kernel<" in name else None


RUN_MARK = "profiled run"  # the record_function around the run that device_profile reads


def device_profile(torch, fn, attempts: int = 3):
    """Run ``fn`` under ``torch.profiler`` and read the device's kernels:
    (device window ms from the first kernel's start to the last one's end,
    busy ms in that window, {"ssd_scan" | "flash_attention" | "matmul" |
    "other": kernel ms} (every pass of the SSD kernel's bf16 body counts as
    ssd_scan), the 5 kernels with the most device time, the number of
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
            "flash_attention_kernel" in name) else "topk_select" if re.search(
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


def init_lm(torch, arch: str):
    """``arch`` at full width, its weights random from a seeded generator,
    on the card."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = models.init_model(cfg, generator=torch.Generator(device="cuda").manual_seed(0),
                              device="cuda").requires_grad_(False)
    torch.cuda.synchronize()
    print(f"path {arch}: {models.param_count(model)} params, init {time.perf_counter() - t0:.3f} s")
    return model, cfg


def drive_scoring(torch, mods, model, cfg, tokens, flags: dict, expect: dict):
    """The scoring forward with ``flags``: a warm-up and 3 timed calls,
    each launching exactly ``expect``. Returns the launches of all four."""
    from repro_torch import models

    total = dict.fromkeys(KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(4):
        reset_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = models.forward(model, {"tokens": tokens}, cfg, **flags)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
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
    print(f"path {cfg.name} scoring, {tokens.shape[0]} x {tokens.shape[1]} tokens, "
          f"{flags or 'flash kernel'}: "
          f"warm-up {secs[0]:.3f} s, then {steady:.4f} s/forward ({[round(x, 4) for x in secs[1:]]}), "
          f"{tokens.numel() / steady:.0f} tokens/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches per forward "
          f"{ {k: v for k, v in expect.items() if v} }")
    return total


def drive_serve(torch, mods, model, cfg, prompts, gen: int, expect: dict, what: str):
    """The serve twin's ``generate``: prefill of ``prompts`` (through the
    flash kernel), then ``gen`` greedy tokens, launching exactly
    ``expect``. Returns (launches, ``generate``'s result)."""
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    reset_counters(mods)
    res = serve.generate(model, cfg, prompts, gen)
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


def check_prefill_vs_forward(torch, mods, model, cfg, prompts, prefill_logits, flags, expect):
    """Prefill's last logits against the scoring forward's last position on
    the same prompts, within twice that forward's own bf16 error (its
    distance from the same forward in f32). The two forwards must launch
    2 x ``expect``; a check, so kept out of the kernels line."""
    import dataclasses

    from repro_torch import models

    reset_counters(mods)
    with torch.inference_mode():
        full, _ = models.forward(model, {"tokens": prompts}, cfg, **flags)
        full32, _ = models.forward(model, {"tokens": prompts}, dataclasses.replace(cfg, dtype="float32"),
                                   **flags)
    launches = read_counters(mods)
    twice = {k: 2 * v for k, v in expect.items()}
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
    expect = dict(dict.fromkeys(KERNELS, 0), ssd_scan=cfg.num_layers)
    total = drive_scoring(torch, mods, model, cfg, tokens, SSD_FLAGS, expect)
    prompts = tokens[:, :PROMPT].contiguous()
    for gen, what in ((2, "warm-up"), (GEN, "batch 4")):
        _, res = drive_serve(torch, mods, model, cfg, prompts, gen, dict.fromkeys(KERNELS, 0), what)
    err = check_ssd_on_path(torch, mods, model, cfg, tokens, expect)
    check_prefill_vs_forward(torch, mods, model, cfg, prompts, res["prefill_logits"],
                             SSD_FLAGS, expect)
    return total, err, (model, cfg, tokens, prompts)


def check_ssd_on_path(torch, mods, model, cfg, tokens, expect):
    """The SSD kernel on the inputs the main path gives it: one more scoring
    forward on the same 4 x 2048 tokens (48 launches, required and kept out
    of the kernels line) hands its first layer's x, dt, A, B and C, strided
    views of the convolution's output, to a recorder; the kernel is then
    held to its plain version on those same views within 2e-5 of max|y|,
    as at the scoring shape in the kernel phase."""
    from repro_torch import models
    from repro_torch.models import ssm

    reset_counters(mods)
    with recording(ssm, "ssd_scan") as seen, torch.inference_mode():
        models.forward(model, {"tokens": tokens}, cfg, use_ssd_kernel=True)
    launches = read_counters(mods)
    require(launches == expect, f"recording forward: launches {launches} != {expect}")
    args, kw = seen[0]
    with torch.inference_mode():
        y = ssm.ssd_scan(*args, **kw)
        ref = mods["ks"].ssd_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    x, dt, _, Bm, _ = args
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    require(x.dtype == torch.bfloat16 and not x.is_contiguous() and not Bm.is_contiguous(),
            f"the path's SSD inputs: {x.dtype}, x strides {x.stride()}, B strides {Bm.stride()}")
    require(err <= 2e-5 * scale, f"ssd_scan on the path's inputs: max abs error {err:.3e} > 2e-5 * "
            f"max|y| ({scale:.3e})")
    print(f"kernel check ssd_scan on layer 0's inputs of the scoring forward {tuple(x.shape)} bf16 "
          f"(x strides {x.stride()}, dt {dt.stride()}, B/C {Bm.stride()}): max_abs_err={err:.3e}, "
          f"relative to max|y| {err / scale:.3e} (max|y| {scale:.3f}; max abs <= 2e-5 max|y|)")
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


def check_flash_on_path(torch, mods, model, cfg, tokens, expect):
    """The flash kernel on the inputs the main path gives it: one more
    scoring forward on the same tokens (26 launches, required and kept out
    of the kernels line) hands the q, k and v of its first local layer
    (window 4096) and of its first global layer to recorders; the kernel is
    then held to its plain version on each within ``flash_tolerance``, and
    the planted faults' distances are printed beside it."""
    from repro_torch import models
    from repro_torch.models import layers

    reset_counters(mods)
    with recording(layers, "flash_attention", lambda args, kw: kw["window"] == 0) as glob, \
            recording(layers, "flash_attention", lambda args, kw: kw["window"] != 0) as local, \
            torch.inference_mode():
        models.forward(model, {"tokens": tokens}, cfg)
    launches = read_counters(mods)
    require(launches == expect, f"gemma2 recording forward: launches {launches} != {expect}")
    worst = 0.0
    for name, seen in (("layer 0 (local)", local), ("layer 1 (global)", glob)):
        (q, k, v), kw = seen[0]
        require(q.dtype == torch.bfloat16
                and q.shape == (*tokens.shape, cfg.num_heads, cfg.resolved_head_dim),
                f"the path's flash inputs: {q.dtype} {tuple(q.shape)}")
        with torch.inference_mode():
            worst = max(worst, check_flash(
                torch, mods["kf"], q, k, v, f"on {name}'s q, k, v of the scoring forward "
                f"{tuple(q.shape)} K={k.shape[2]} {kw}", faults="report", **kw))
    return worst


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
        # name, kernel, plain, library call, bytes, fp32 operations
        ("qsgd_quantize", lambda: kq.qsgd_quantize(x, u, S), lambda: kq.quantize_plain(x, u, S),
         None, 9 * n + 4 * rows, 13 * n),
        ("qsgd_dequantize", lambda: kq.qsgd_dequantize(lev, nrm, S),
         lambda: kq.dequantize_plain(lev, nrm, S), None, 5 * n + 4 * rows, n + rows),
        ("qsgd_dequant_reduce", lambda: kq.qsgd_dequant_reduce(lev4, nrm4, w4, S),
         lambda: kq.dequant_reduce_plain(lev4, nrm4, w4, S), None,
         PEERS * n + 4 * PEERS * rows + 4 * PEERS + 4 * n, 2 * PEERS * n + 2 * PEERS * rows),
        # library: the same function at uniform weights, up to the atomics' summation order
        ("topk_scatter_accum", lambda: kt.topk_scatter_accum(vals4, idx4, w4, n),
         lambda: kt.scatter_accum_plain(vals4, idx4, w4, n),
         lambda: torch.zeros((n,), device="cuda").index_add_(0, idx64, vals4.view(-1), alpha=1 / PEERS),
         8 * PEERS * k + 4 * PEERS + 4 * n, 2 * PEERS * k),
    )
    out = {}
    for name, kern, plain, library, nbytes, ops in cases:
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
        nbytes = rows * (4 * n + 8 * k)
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
    nbytes = sum(PEERS * (4 * x.shape[1] + 8 * topk_k(x.shape[1])) for x in leaves)
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


def bank_bytes(peers, k, mixes, n, own=True):
    """The bytes a bank scatter must move: vbank and idx (and vals) read,
    W read, every row written once."""
    return 8 * peers * k + (4 * peers * k if own else 0) + 4 * mixes * peers + 4 * (
        mixes + (peers if own else 0)) * n


def scatter_timing(torch, kt):
    """The bank scatter as the mobilenet top-k + EF device step calls it (1
    mix + 4 own rows, the select's payload) at 240 (the median leaf),
    82,944 and 589,824 entries and at fc2/w, then one device step's 180
    bank scatters together; beside the plain version and the bound (bytes:
    ``bank_bytes``). ``kt`` without a bank scatter (an earlier checkout's)
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
        nbytes = bank_bytes(PEERS, k, 1, n)
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
    nbytes = sum(bank_bytes(PEERS, i.shape[1], 1, n) for _, _, i, n in leaves)
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
        nbytes = 2 * Bsz * S_ * H * P + 4 * Bsz * S_ * H + 4 * H + 2 * 2 * Bsz * S_ * G * N \
            + 4 * Bsz * S_ * H * P
        ops = 4 * Bsz * S_ * H * P * N
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


def flash_bound(torch, q, k, window: int):
    """(bound ms, bound_by, bytes, operations) of causal flash attention on
    these inputs: q, k, v read once and o written once at 3.35 TB/s, against
    4 D H B per valid (query, key) pair, pairs = sum_i min(i + 1, window)
    (the pairs this run's mask keeps, not the whole square), at the dense
    bf16 tensor-core rate for bf16 inputs or the fp32 rate for f32."""
    B, S_, H, D = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    i = torch.arange(S_, dtype=torch.float64)
    pairs = float(torch.clamp(i + 1, max=window).sum()) if window else S_ * (S_ + 1) / 2
    ops = 4 * D * H * B * pairs
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops


def flash_timing(torch, kf):
    """The flash kernel and its plain version (plain, kernel, kernel, plain)
    at gemma2-2b's scoring shape in bf16 with softcap 50, for a local layer
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
        kern = lambda: kf.flash_attention(q, k, v, softcap=GEMMA_SOFTCAP, window=window)
        plain = lambda: kf.flash_attention_plain(q, k, v, softcap=GEMMA_SOFTCAP, window=window)
        flex_err = float((got.transpose(1, 2).float() - kern().float()).abs().max())
        t_plain1, _ = time_ms(torch, plain, 3)
        t_kern1, host1 = time_ms(torch, kern, 10)
        t_kern2, host2 = time_ms(torch, kern, 10)
        t_plain2, _ = time_ms(torch, plain, 3)
        t_lib, _ = time_ms(torch, lib, 20)
        bound, by, nbytes, ops = flash_bound(torch, q, k, window)
        row = {"ms": min(t_kern1, t_kern2), "plain_ms": min(t_plain1, t_plain2), "bound_ms": bound,
               "bound_by": by, "library_ms": t_lib}
        print(f"timing flash_attention {FLASH_SCORING} bf16 softcap {GEMMA_SOFTCAP} window {window}: "
              f"kernel {t_kern1:.4f}/{t_kern2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound "
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
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels import topk as kt

    mods = {"kq": kq, "kt": kt, "ks": ks, "kf": kf}
    start = time.perf_counter()
    stamp = lambda what: print(f"[{time.perf_counter() - start:.1f} s] {what} done", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    card = card_line()
    print(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all([kq.SOURCE, kt.SOURCE, ks.SOURCE, kf.SOURCE])
    for mod in (kq, kt, ks, kf):
        mod.load_library()
    print(f"build: {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} in {time.perf_counter() - t0:.2f} s")

    checks = kernel_phase(torch, kq)
    errs = {name: checks[name][0] for name in checks}
    errs.update(new_kernel_phase(torch, kq, kt))
    errs["ssd_scan"] = ssd_kernel_phase(torch, ks)
    errs["flash_attention"] = flash_kernel_phase(torch, kf)
    grad_guard_phase(torch, kf, ks)
    stamp("kernels phase")
    reference_phase(torch)
    reference_step_phase(torch)
    reference_async_phase(torch)
    robust_reference_phase(torch)
    reference_lm_phase(torch, "mamba2-370m", 40, SSD_FLAGS)
    reference_lm_phase(torch, "gemma2-2b", 160, {})  # 160 > the window of 64
    stamp("reference phase")

    total = dict.fromkeys(KERNELS, 0)
    runs = (
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
    for counts in (lm_counts, gemma_counts):
        for name, count in counts.items():
            total[name] += count
    require(all(total.values()), f"a kernel was never launched on the main path: {total}")

    times = timing_phase(torch, kq, kt)
    times.update(select_timing(torch, kt))
    scatter_timing(torch, kt)
    times.update(ssd_timing(torch, ks))
    times.update(flash_timing(torch, kf))
    estimator_timing(torch)
    stamp("timing phase")
    mamba_cfg = lm_run[1]  # every layer's scan: the three passes of the bf16 body, no f32 body
    profile_phase(torch, "mamba2-370m", *lm_run, SSD_FLAGS,
                  {f"ssd {p}": mamba_cfg.num_layers for p in ("states", "carry", "outputs")})
    gemma_cfg = gemma_run[1]  # every layer's scoring attention: the bf16 body at its headdim
    profile_phase(torch, "gemma2-2b", *gemma_run, {},
                  {f"wgmma<{gemma_cfg.resolved_head_dim}>": gemma_cfg.num_layers})
    stamp("profile phase")
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

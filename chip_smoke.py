#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, no arguments

Phases, each of which fails the run on a failed check (none catches its own
failure):

1. build   — compile every CUDA source of the port with nvcc (into build/),
             one nvcc per source, all started together.
2. kernels — each kernel against its plain PyTorch version on the card: the
             QSGD kernels at VGG-11's largest leaf (8192 x 2048 buckets),
             ragged shapes and all-zero buckets; dequantize-and-reduce at
             (4, 8192, 2048) and ragged shapes; the top-k select at fc2/w
             (16,777,216 elements, k = 1 %), n = 301 with k = 3, exact ties,
             a leaf of mostly exact zeros, an all-zero leaf and k = n; the
             scatter at P = 4 with shared indices.
3. reference — small runs on the card against the same runs on the CPU
             (plain versions), same init and uniforms: a 4-peer squeezenet
             QSGD cluster epoch, and one device train step with qsgd + EF
             and with topk + EF.
4. path    — the main paths. ``LocalP2PCluster(...).run`` with the QSGD
             exchange: mobilenet-v3-small (full graph, 3 epochs), vgg11
             (full graph, 2 epochs), mobilenet-v3-small (ring, EF, 1 epoch);
             with the top-k exchange: mobilenet-v3-small (full graph, EF,
             1 epoch). ``build_p2p_train_step`` at full width: vgg11 with
             qsgd(127, 2048) + EF and mobilenet-v3-small with topk(0.01) +
             EF, 4 peers x batch 32 on CIFAR-shaped 32x32 data, 4 steps
             each. Launch counters are zeroed before and read after each
             run and must equal the counts the path implies.
5. timing  — each kernel, its plain version, the PyTorch call that computes
             the same function where there is one, and the bound, at the
             main path's largest shapes, timed with CUDA events.

The last two lines of stdout are a ``{"kernels": [...]}`` JSON line and the
result ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
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
}


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


def topk_leaf(torch, n, kind, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((n,), generator=g, device="cuda") * 0.01
    if kind == "ties":
        x = torch.round(x * 400) / 400  # many exact magnitude ties
    elif kind == "mostly_zero":
        x[torch.rand((n,), generator=g, device="cuda") < 0.97] = 0.0
        x[3], x[11] = 1e-25, -3e-38  # below max * 2**-64: the bracket stays open
    elif kind == "zeros":
        x.zero_()
    return x


def check_select(torch, kt, x, k, kind):
    """Values and indices identical to the plain version (the Pallas
    kernel's bisection and slot order)."""
    v, i = kt.topk_select_pack(x, k)
    pv, pi = kt.select_pack_plain(x, k)
    torch.cuda.synchronize()
    require(torch.equal(i, pi), f"select indices differ at n={x.numel()} k={k} ({kind})")
    require(torch.equal(v, pv), f"select values differ at n={x.numel()} k={k} ({kind})")
    require(torch.equal(v, x[i.long()]), f"select values are not x[idx] at n={x.numel()} k={k}")
    print(f"kernel check select n={x.numel()} k={k} ({kind}): identical values and indices")
    return 0.0


def check_scatter(torch, kt, n, k, peers=PEERS):
    """Bit-identical to the plain version: peers added in order p = 0..P-1,
    every product rounded before its add."""
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
    require(torch.equal(out_k, out_p), f"scatter not bit-identical at P={peers} k={k} n={n}")
    err = float((out_k - out_p).abs().max())
    print(f"kernel check scatter P={peers} k={k} n={n} (shared indices): max_abs_err={err:.3e}")
    return err


def new_kernel_phase(torch, kq, kt):
    errs = {"qsgd_dequant_reduce": 0.0, "topk_select_pack": 0.0, "topk_scatter_accum": 0.0}
    for peers, nb, bucket, offset in ((PEERS, FC2_ROWS, BUCKET, 0), (3, 13, 256, 0),
                                      (PEERS, 5, 301, 0), (2, 13, 256, 1)):
        errs["qsgd_dequant_reduce"] = max(errs["qsgd_dequant_reduce"],
                                          check_dequant_reduce(torch, kq, peers, nb, bucket, offset))
    for n, k, kind in ((FC2, FC2_K, "normal"), (301, 3, "normal"), (4097, 41, "ties"),
                       (4097, 2000, "ties"), (4097, 41, "mostly_zero"), (301, 3, "zeros"),
                       (4097, 4097, "normal"), (16, 1, "normal")):
        check_select(torch, kt, topk_leaf(torch, n, kind, seed=n + k), k, kind)
    for n, k in ((FC2, FC2_K), (4097, 41), (7, 7)):
        errs["topk_scatter_accum"] = max(errs["topk_scatter_accum"], check_scatter(torch, kt, n, k))
    return errs


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


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def drive(torch, mods, arch: str, epochs: int, *, exchange: str = "qsgd", graph: str = "full",
          ef: bool = False):
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster, QSGDConfig
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    reset_counters(mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = LocalP2PCluster(
        get_config(arch), make_dataset("cifar"), num_peers=PEERS, batch_size=32,
        batches_per_epoch=2, optimizer=sgd(momentum=0.9), lr=0.01,  # table1_resource_stages.py
        exchange=exchange, qsgd=QSGDConfig(levels=S, bucket=BUCKET), topk_frac=TOPK_FRAC,
        graph=graph, ef=ef, seed=0,
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
    else:
        expect.update(topk_select_pack=epochs * PEERS * leaves, topk_scatter_accum=decodes)
    tag = f"cluster {arch} {exchange} graph={graph} ef={ef}"
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
    return launches


def drive_step(torch, mods, arch: str, steps: int, *, exchange: str):
    """``build_p2p_train_step`` at full width: 4 peers x batch 32 on
    CIFAR-shaped data, SGD with momentum, lr 0.01, EF on; the first step is
    timed apart (cuDNN plans, first launches)."""
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
        expect.update(topk_select_pack=steps * PEERS * leaves, topk_scatter_accum=steps * 2 * leaves)
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
    return launches


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


def timing_phase(torch, kq, kt):
    """Each kernel at the main path's largest shape, in turns with its plain
    version (plain, kernel, kernel, plain), and the one PyTorch call that
    computes the same function where there is one. Bounds count each input
    byte read once and each output byte written once, at 3.35 TB/s, and the
    function's fp32 operations at 67 TFLOP/s; the larger bounds it."""
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
        # select: one read of x and the packed output; one compare per element
        ("topk_select_pack", lambda: kt.topk_select_pack(flat, k), lambda: kt.select_pack_plain(flat, k),
         lambda: torch.topk(flat.abs(), k), 4 * n + 8 * k, n),
        ("topk_scatter_accum", lambda: kt.topk_scatter_accum(vals4, idx4, w4, n),
         lambda: kt.scatter_accum_plain(vals4, idx4, w4, n), None,
         8 * PEERS * k + 4 * PEERS + 4 * n, 2 * PEERS * k),
    )
    out = {}
    for name, kern, plain, library, nbytes, ops in cases:
        iters = 10 if name == "topk_select_pack" else 50
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
            + ("none: no single PyTorch call computes it" if t_lib is None else f"{t_lib:.4f} ms")
        )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import topk as kt

    mods = {"kq": kq, "kt": kt}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    card = card_line()
    print(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all([kq.SOURCE, kt.SOURCE])
    kq.load_library()
    kt.load_library()
    print(f"build: {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} in {time.perf_counter() - t0:.2f} s")

    checks = kernel_phase(torch, kq)
    errs = {name: checks[name][0] for name in checks}
    errs.update(new_kernel_phase(torch, kq, kt))
    reference_phase(torch)
    reference_step_phase(torch)

    total = dict.fromkeys(KERNELS, 0)
    runs = (
        (drive, "mobilenet-v3-small", 3, dict(graph="full")),
        (drive, "vgg11", 2, dict(graph="full")),
        (drive, "mobilenet-v3-small", 1, dict(graph="ring", ef=True)),
        (drive, "mobilenet-v3-small", 1, dict(exchange="topk", ef=True)),
        (drive_step, "vgg11", 4, dict(exchange="qsgd")),
        (drive_step, "mobilenet-v3-small", 4, dict(exchange="topk")),
    )
    for fn, arch, length, kw in runs:
        for name, count in fn(torch, mods, arch, length, **kw).items():
            total[name] += count
    require(all(total.values()), f"a kernel was never launched on the main path: {total}")

    times = timing_phase(torch, kq, kt)
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

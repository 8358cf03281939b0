#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, no arguments

Phases, each of which fails the run on a failed check (none catches its own
failure):

1. build   — compile every CUDA source of the port with nvcc (into build/).
2. kernels — each kernel against its plain PyTorch version on the card, at
             VGG-11's largest leaf (8192 x 2048), ragged shapes and an
             all-zero bucket.
3. reference — a small 4-peer QSGD epoch on the card against the same epoch
             on the CPU (plain versions), same init and uniforms.
4. path    — the main path: ``LocalP2PCluster(...).run`` with the QSGD
             exchange, mobilenet-v3-small (full graph, 3 epochs), vgg11
             (full graph, 2 epochs) and mobilenet-v3-small (ring, EF,
             1 epoch). Launch counters are zeroed before and read after
             each run and must equal the counts the path implies.
5. timing  — each kernel, its plain version, and the memory bound, at the
             fc2/w shape, timed with CUDA events.

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
FC2_ROWS = 4096 * 4096 // BUCKET  # vgg11 fc2/w, the largest leaf: 8192 buckets


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counters(kq) -> None:
    kq.qsgd_quantize.launches = 0
    kq.qsgd_dequantize.launches = 0


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


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


def drive(torch, kq, arch: str, epochs: int, *, graph: str = "full", ef: bool = False):
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster, QSGDConfig
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    peers = 4
    reset_counters(kq)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cluster = LocalP2PCluster(
        get_config(arch), make_dataset("cifar"), num_peers=peers, batch_size=32,
        batches_per_epoch=2, optimizer=sgd(momentum=0.9), lr=0.01,  # table1_resource_stages.py
        exchange="qsgd", qsgd=QSGDConfig(levels=S, bucket=BUCKET), graph=graph, ef=ef,
        seed=0,
    )
    t1 = time.perf_counter()
    history = cluster.run(epochs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"qsgd_quantize": kq.qsgd_quantize.launches, "qsgd_dequantize": kq.qsgd_dequantize.launches}

    leaves = len(cluster.peers[0].params)
    degree_sum = sum(cluster.graph.degree(r) for r in range(peers))
    expect = {
        "qsgd_quantize": epochs * peers * leaves,
        "qsgd_dequantize": epochs * (degree_sum + (peers if ef else 0)) * leaves,
    }
    tag = f"{arch} graph={graph} ef={ef}"
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


def timing_phase(torch, kq):
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    x = torch.randn((FC2_ROWS, BUCKET), generator=g, device="cuda") * 0.01
    u = torch.rand((FC2_ROWS, BUCKET), generator=g, device="cuda")
    lev, nrm = kq.quantize_plain(x, u, S)
    n, rows = x.numel(), FC2_ROWS
    out = {}
    # quantize: read x and u, write levels and norms; ~13 fp32 ops per element
    q_bytes, q_ops = 9 * n + 4 * rows, 13 * n
    # dequantize: read levels and norms, write f32; 1 multiply per element
    d_bytes, d_ops = 5 * n + 4 * rows, n + rows
    for name, kern, plain, nbytes, ops in (
        ("qsgd_quantize", lambda: kq.qsgd_quantize(x, u, S), lambda: kq.quantize_plain(x, u, S), q_bytes, q_ops),
        ("qsgd_dequantize", lambda: kq.qsgd_dequantize(lev, nrm, S), lambda: kq.dequantize_plain(lev, nrm, S), d_bytes, d_ops),
    ):
        t_plain1, _ = time_ms(torch, plain)
        t_kern1, host1 = time_ms(torch, kern)
        t_kern2, host2 = time_ms(torch, kern)
        t_plain2, _ = time_ms(torch, plain)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS * 1e3
        out[name] = {
            "ms": min(t_kern1, t_kern2),
            "plain_ms": min(t_plain1, t_plain2),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        print(
            f"timing {name} at ({FC2_ROWS}, {BUCKET}): kernel {t_kern1:.4f}/{t_kern2:.4f} ms, "
            f"plain {t_plain1:.4f}/{t_plain2:.4f} ms, bound {out[name]['bound_ms']:.4f} ms "
            f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; roofline share "
            f"{out[name]['bound_ms'] / out[name]['ms']:.0%}), host enqueue "
            f"{min(host1, host2) * 1e3:.1f} us/call; no single PyTorch call computes it "
            f"(library_ms null)"
        )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import qsgd as kq

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    card = card_line()
    print(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    libs = build.build_all([kq.SOURCE])
    kq.load_library()
    print(f"build: {', '.join(str(p.relative_to(ROOT)) for p in libs.values())} in {time.perf_counter() - t0:.2f} s")

    checks = kernel_phase(torch, kq)
    reference_phase(torch)

    total = {"qsgd_quantize": 0, "qsgd_dequantize": 0}
    for arch, epochs, graph, ef in (
        ("mobilenet-v3-small", 3, "full", False),
        ("vgg11", 2, "full", False),
        ("mobilenet-v3-small", 1, "ring", True),
    ):
        launches = drive(torch, kq, arch, epochs, graph=graph, ef=ef)
        for k in total:
            total[k] += launches[k]

    times = timing_phase(torch, kq)
    replaces = {"qsgd_quantize": "src/repro/kernels/qsgd.py:22", "qsgd_dequantize": "src/repro/kernels/qsgd.py:36"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/qsgd.cu",
            "replaces": replaces[name],
            "launches": total[name],
            "max_abs_err": checks[name][0],
            **times[name],
            "library_ms": None,
        }
        for name in ("qsgd_quantize", "qsgd_dequantize")
    ]
    print(f"nvidia-smi: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The split of the top-k scatter's earlier kernel on one NVIDIA card.

    python3 scripts/scatter_tuning.py

The cooperative kernel that ``topk_scatter_accum`` launched before its tile
and long-row bodies is kept, cut into phases, in ``scripts/scatter_tuning.cu``.
At fc2/w (P = 4, every peer sharing every index) and at the device step's
banks of 240, 82,944 and 589,824 entries (P = 4: the mix, and the P = 1
launch over a (P * n) buffer that made the own images) this prints the
device time of the zero pass, of one grid sync, of each peer phase and of
the whole kernel, by difference between launches cut after each phase; an
empty kernel launched cooperatively and normally; and the host time of one
launch with the SM count and the occupancy queried on every call, as that
launch did, and cached. Last, the rate at which the card writes fc2/w's
zeros with 16-byte stores: the floor of any body that writes the output.
``chip_smoke.py --scatter-timing`` times the port's own bodies.

Times are CUDA events behind a spin kernel (``chip_smoke.time_ms``); the
card's name and power limit are printed first. The probe builds into
``build/tuning/`` with the port's nvcc flags.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the port's src on the path)

OUT = ROOT / "build" / "tuning"
SIZES = (240, 82944, 589824)


def compile_probe(build) -> Path:
    """``scatter_tuning.cu`` built with the port's nvcc flags."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "scatter_probe.so"
    src = ROOT / "scripts" / "scatter_tuning.cu"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    cs.require(proc.returncode == 0, f"nvcc {src.name}: {proc.stdout}{proc.stderr}")
    return lib


def split(torch, kt, probe):
    """The earlier kernel's phases at fc2/w and at the device step's banks."""
    from repro_torch.kernels import build

    c = ctypes
    probe.probe_scatter_launch.argtypes = [c.c_void_p] * 4 + [c.c_int, c.c_longlong, c.c_longlong,
                                                              c.c_int, c.c_int, c.c_void_p]
    probe.probe_empty_launch.argtypes = [c.c_int, c.c_int, c.c_void_p]
    probe.probe_scatter_grid.argtypes = [c.c_longlong, c.c_longlong, c.c_int]
    probe.probe_scatter_host_us.argtypes = [c.c_void_p] * 4 + [c.c_int, c.c_longlong, c.c_longlong,
                                                               c.c_int, c.c_int, c.c_void_p]
    probe.probe_scatter_host_us.restype = c.c_double
    stream = build.cuda_stream(torch.device("cuda"))
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    flat = torch.randn((cs.FC2,), generator=g, device="cuda") * 0.01
    sel_v, sel_i = kt.topk_select_pack(flat, cs.FC2_K)
    cases = [("fc2/w, P = 4 sharing every index",
              torch.stack([sel_v * (p + 1) for p in range(cs.PEERS)]), torch.stack([sel_i] * cs.PEERS),
              torch.full((cs.PEERS,), 1.0 / cs.PEERS, device="cuda"), cs.FC2)]
    for n in SIZES:
        _, vals, idx = cs.select_payload(torch, kt, n, cs.PEERS, seed=n)
        cases.append((f"bank ({cs.PEERS}, {n}) mix", vals, idx,
                      torch.full((cs.PEERS,), 1.0 / cs.PEERS, device="cuda"), n))
        offset = torch.arange(cs.PEERS, dtype=torch.int32, device="cuda")[:, None] * n
        cases.append((f"bank ({cs.PEERS}, {n}) own images, P = 1 over {cs.PEERS * n}", vals.reshape(1, -1),
                      (idx + offset).reshape(1, -1).contiguous(), torch.ones((1,), device="cuda"),
                      cs.PEERS * n))
    for what, v, idx, w, n in cases:
        peers, k = v.shape
        out = torch.empty((n,), device="cuda")
        args = (v.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), peers, k, n)

        def launch(mode, cached=1):
            err = probe.probe_scatter_launch(*args, mode, cached, stream)
            cs.require(err == 0, f"probe launch: cudaError {err}")

        launch(-1)
        torch.cuda.synchronize()
        cs.require(cs.same_bits(torch, out, kt.scatter_accum_plain(v, idx, w, n)),
                   f"the earlier kernel differs from the plain version at {what}")
        t = {mode: cs.time_ms(torch, lambda m=mode: launch(m), 50)[0] for mode in range(peers + 2)}
        blocks = probe.probe_scatter_grid(k, n, 1)
        empty_coop = cs.time_ms(torch, lambda: probe.probe_empty_launch(blocks, 1, stream), 50)[0]
        empty_norm = cs.time_ms(torch, lambda: probe.probe_empty_launch(blocks, 0, stream), 50)[0]
        host_q = probe.probe_scatter_host_us(*args, 0, 200, stream)
        host_c = probe.probe_scatter_host_us(*args, 1, 200, stream)
        torch.cuda.synchronize()
        peers_ms = [t[2] - t[1]] + [t[q + 2] - t[q + 1] for q in range(1, peers)]
        print(f"split of the earlier scatter, {what}, k {k}: whole kernel {t[peers + 1]:.4f} ms; zero "
              f"pass alone {t[0]:.4f} ms (an empty cooperative launch of {blocks} blocks "
              f"{empty_coop:.4f}, normal {empty_norm:.4f}); zero + one grid sync {t[1]:.4f} "
              f"(the sync {t[1] - t[0]:.4f}); peer phases "
              + ", ".join(f"{x:.4f}" for x in peers_ms)
              + f" (peer 0 without its sync, the others with); host per launch {host_q:.2f} us with "
              f"the occupancy queried, {host_c:.2f} us cached")


def fill_rate(torch, probe):
    """How fast the card writes fc2/w's 67 MB of zeros with 16-byte stores,
    at several grid sizes: the floor of any body that writes the output."""
    from repro_torch.kernels import build

    probe.probe_fill_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    stream = build.cuda_stream(torch.device("cuda"))
    out = torch.empty((cs.FC2,), device="cuda")
    line = []
    for grid in (264, 528, 1056, 2112, 16384):
        t, _ = cs.time_ms(torch, lambda: probe.probe_fill_launch(out.data_ptr(), cs.FC2, grid, stream), 50)
        line.append(f"{grid} blocks {t:.4f} ms ({4 * cs.FC2 / t / 1e9:.2f} TB/s)")
    print("zeroing fc2/w's 67.1 MB with 16-byte stores: " + ", ".join(line))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scatter_tuning: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import topk as kt

    print(f"nvidia-smi: {cs.card_line()}")
    probe = ctypes.CDLL(str(compile_probe(build)))
    kt.load_library()
    split(torch, kt, probe)
    fill_rate(torch, probe)
    return 0


if __name__ == "__main__":
    sys.exit(main())

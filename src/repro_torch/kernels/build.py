"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface and compiles on its own
into ``build/<stem>-<hash>.so`` at the repository root (``.gitignore`` lists
``build/``). The hash covers the source, the headers of ``csrc/`` it
includes and the flags, so an edited source or header is rebuilt and a
finished build is reused. Several sources build in
parallel: one ``nvcc`` each, all started together.

Nothing here runs at import time; the first kernel launch builds what it
needs. Tensors on the ``meta`` device build and launch nothing: a wrapper
given one runs its checks and allocates its outputs and scratch (shapes
and dtypes only), then reports its kernel's cost (``charge``), as it does
after each launch on the card. ``launch.op_analysis`` counts those costs
beside every PyTorch op (the H100 dry run). Each build runs with ``-Xptxas -v`` and keeps nvcc's output beside
the library (``build/<stem>-<hash>.log``): what ptxas reports for each
kernel, registers, shared memory and spills. ``python -m
repro_torch.kernels.build SOURCE...`` builds the named sources if needed
and prints it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# sm_90a keeps Hopper-only instructions available. No --use_fast_math: the
# QSGD parity rules need IEEE division and sqrtf. -Xptxas -v: the build's
# log holds each kernel's registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin; the port's CUDA "
            "kernels are built from source at first use"
        )
    return str(path)


def headers(source: str) -> List[Path]:
    """The headers under ``csrc/`` that ``csrc/<source>`` includes with
    ``#include "..."``, directly or through another such header."""
    found: List[Path] = []
    todo = [CSRC / source]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / name
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(source: str) -> Path:
    """``build/<stem>-<hash>.so``: the hash covers the source, every header
    of ``csrc/`` it includes and the flags, so an edited header rebuilds
    each source that includes it."""
    src = CSRC / source
    parts = [src.read_bytes()] + [h.read_bytes() for h in headers(source)]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile every source not built yet, one ``nvcc`` per source in
    parallel, each one's output kept beside its library (``.log``); returns
    ``{source: library path}``. Raises with the compiler's output if any
    build fails."""
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for s in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-o", tmp, str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failures = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            out[s].with_suffix(".log").write_text(log)
            os.replace(tmp, out[s])  # atomic: a concurrent process sees all or nothing
        else:
            os.unlink(tmp)
            failures.append(f"{s}: nvcc exited {proc.returncode}\n{log}")
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_all([source])[source]))


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of ``dtype``."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name} must be a {ndim}-d {dtype} tensor, got {t.dim()}-d {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise before a launch whose output would cut the autograd graph: a
    kernel without a backward (the SSD scan's, as the reference's Pallas
    scan has no gradient either) fills a fresh buffer. Under
    ``torch.no_grad()`` or ``torch.inference_mode()``, or with no input that
    requires grad, nothing is refused."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel on CUDA: the reference's Pallas kernel has no "
            "gradient either (ROADMAP reference behaviour 18), and its lm_loss trains through "
            "the chunked scan (use_ssd_kernel=False); call the kernel under "
            "torch.inference_mode() or torch.no_grad(), or on CPU tensors, where its plain "
            "version differentiates"
        )


# The cost sinks (``launch.op_analysis.OpCount`` while it is active) that
# each kernel's (name, FLOPs, bytes) is reported to.
SINKS: List = []


def charge(name: str, flops: float, nbytes: float) -> None:
    """Report one kernel call's cost (its module's ``*_cost`` function) to
    every active sink: after a launch on the card, or in place of one on the
    meta device."""
    for sink in SINKS:
        sink.charge(name, flops, nbytes)


def on_meta(t: torch.Tensor) -> bool:
    """True for a tensor on the meta device: the wrapper takes its CUDA
    route's checks and allocations, charges its cost and launches nothing."""
    return t.device.type == "meta"


def cuda_stream(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, for a kernel launch; a device
    that is neither the CPU nor CUDA raises."""
    if device.type != "cuda":
        raise ValueError(f"the port's kernels run on CUDA or CPU tensors, got {device}")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def fold(info, in_dims, tensors):
    """Tensors under ``vmap`` -> plain tensors with the vmapped dimension
    folded into the batch (an unbatched one expanded to it): a kernel
    wrapper's ``vmap`` rule launches once for every slice, since a kernel
    that reads ``data_ptr()`` cannot see a batched tensor."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand(info.batch_size, *t.shape) if d is None else t.movedim(d, 0)
        out.append(t.flatten(0, 1))  # also the (P, B, 0) statistics of an f32 CUDA forward
    return out


def unfold(info, tensors):
    """Outputs of a launch on folded tensors -> outputs batched in dim 0."""
    return tuple(t.unflatten(0, (info.batch_size, -1)) for t in tensors)


def ptxas_report(source: str) -> str:
    """What ptxas reported when ``csrc/<source>`` was built (``-Xptxas -v``
    in its build log), building it first if needed."""
    return build_all([source])[source].with_suffix(".log").read_text()


if __name__ == "__main__":
    for name in sys.argv[1:]:
        print(f"== {name}\n{ptxas_report(name)}")

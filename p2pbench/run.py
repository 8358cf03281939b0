"""The benchmark's one command: one run of one cell on the card it starts on.

    python3 p2pbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted`` (steps timed), ``failed`` (of those, steps with
a non-finite loss), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also end its standard error. It exits
non-zero, printing no result, without as many CUDA cards as the cell asks
for, and when JAX or the JAX package was loaded.

The port's kernels build at their first use into ``build/`` inside the
checkout (``repro_torch.kernels.build``), so only a checkout's first run
of a cell compiles.
"""
import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from p2pbench import harness

    print(f"[{time.perf_counter() - T0:.3f} s] imports done", file=sys.stderr)

    manifest, cell, config = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, cell, config, manifest, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace), device="cuda:0", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"refusing to report: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

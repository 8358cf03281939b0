"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size, in one process:

    python3 p2pbench/calibrate.py --workload <cell> --seeds 1-12 --controls 3 --faults 3

For every seed, the numbers ``harness.compare`` holds to the limits
between the program's first steps (through ``P2PTrainer.step``, as a run's
set-up drives them) and the plain reference: the lower readings. For the
first ``--controls`` seeds, the same numbers between the control (the
reference computed in the configuration's ``control`` precision, the next
below its own) and the reference; for the first ``--faults`` seeds, between
the reference with each planted fault and the reference: the upper
readings. One JSON line per reading, then a summary line: the largest
lower and the smallest upper reading of each number. The benchmark's runs
do not run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from p2pbench import harness
    from p2pbench.reference.p2p import FAULTS

    _, cell, config = harness.load_cell(args.workload, ROOT)
    fam = harness.family(config)
    device = torch.device(args.device)
    lower, upper = {}, {}

    def emit(kind, seed, numbers, extra=None):
        print(json.dumps({"kind": kind, "seed": seed, **numbers, **(extra or {})}), flush=True)

    for n, seed in enumerate(args.seeds):
        t = time.perf_counter()
        trainer, state, pool, prog = harness.setup_program(config, cell, seed, device)
        del trainer, state, pool
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = harness.reference_readings(fam, config, cell, seed, device)
        got = harness.compare(prog, ref)
        emit("program", seed, got, {"losses": prog["losses"], "ref_losses": ref["losses"],
                                    "seconds": time.perf_counter() - t})
        for k, v in got.items():
            lower[k] = max(lower.get(k, 0.0), v)
        planted = ([("control", config["control"], None)] if n < args.controls else []) + (
            [("fault " + f, "f32", f) for f in FAULTS if f != "unchanged"] if n < args.faults else [])
        for kind, precision, fault in planted:
            other = harness.reference_readings(fam, config, cell, seed, device, precision=precision,
                                               fault=fault)
            got = harness.compare(other, ref)
            emit(kind, seed, got)
            for k, v in got.items():
                upper.setdefault(kind, {})[k] = min(upper.get(kind, {}).get(k, float("inf")), v)
    print(json.dumps({"kind": "summary", "workload": args.workload, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

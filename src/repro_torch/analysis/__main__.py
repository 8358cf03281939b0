"""CLI for the port's analysis passes.

    python -m repro_torch.analysis [--fail-on SEV] [--json FILE]
                                   [--passes contracts,trace] [--fast]
                                   [--device cuda|cpu]

Exit status is 1 when any finding is at or above ``--fail-on`` (default
``error``; ``never`` always exits 0), as the reference's CLI. ``--fast``
leaves out the trace pass's cluster scenario, which trains on
``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import ALL_PASSES, SEVERITIES, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run the port's contracts and trace passes.",
    )
    ap.add_argument(
        "--fail-on", default="error", choices=(*SEVERITIES, "never"),
        help="exit 1 when any finding is at/above this severity (default: error)",
    )
    ap.add_argument("--json", type=Path, default=None, metavar="FILE",
                    help="also write the full report as JSON")
    ap.add_argument("--passes", default=",".join(ALL_PASSES), metavar="P1,P2",
                    help=f"comma-separated subset of: {', '.join(ALL_PASSES)}")
    ap.add_argument("--fast", action="store_true",
                    help="leave out the trace pass's cluster scenario")
    ap.add_argument("--device", default="cuda",
                    help="device of the trace pass's cluster scenario (default: cuda)")
    args = ap.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    report = run_analysis(passes=passes, deep=not args.fast, device=args.device)
    if args.json is not None:
        report.write_json(args.json)
    print(report.render())
    return 1 if report.failed(args.fail_on) else 0


if __name__ == "__main__":
    sys.exit(main())

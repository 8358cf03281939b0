"""The command refuses to report without a card, and in a checkout that
holds only the benchmark's own files: a non-zero exit and nothing on
standard output."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "vgg11.p4x512.mean", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def run(root: Path):
    return subprocess.run([sys.executable, str(root / "p2pbench" / "run.py"), *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count():
        pytest.skip("a CUDA card is visible; the run would report")


def test_without_a_card(no_card):
    done = run(ROOT)
    assert done.returncode != 0 and done.stdout == ""
    assert "needs 1 CUDA card" in done.stderr


def test_with_only_the_benchmarks_files(tmp_path):
    shutil.copytree(ROOT / "p2pbench", tmp_path / "p2pbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    done = run(tmp_path)
    assert done.returncode != 0 and done.stdout == ""

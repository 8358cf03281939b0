"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it runs on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{f.relative_to(ROOT)}:{line}: {mod}"
        for f in files
        for line, mod in _imported_roots(f)
        if mod in FORBIDDEN
    ]
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "import repro_torch.core.simulate, repro_torch.core.p2p, repro_torch.convert\n"
        "import repro_torch.optim, repro_torch.kernels.qsgd, repro_torch.kernels.topk\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.core.events, repro_torch.core.cost, repro_torch.core.instance\n"
        "import repro_torch.core.serverless, repro_torch.core.scheduler, repro_torch.core.mailbox\n"
        "import repro_torch.core.robust, repro_torch.core.shard, repro_torch.core.tree\n"
        "import repro_torch.analysis.trace, repro_torch.examples.quickstart\n"
        "import repro_torch.examples.cost_explorer\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"


def test_cluster_defaults_to_the_card_and_refuses_to_fall_back():
    from repro_torch.configs import get_config
    from repro_torch.core import LocalP2PCluster
    from repro_torch.data import make_dataset
    from repro_torch.optim import sgd

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalP2PCluster(
            get_config("squeezenet1.1"), make_dataset("mnist", size=64, image_hw=8, channels=1),
            num_peers=2, batch_size=4, batches_per_epoch=1, optimizer=sgd(),
        )


def test_kernel_wrappers_raise_on_a_device_they_do_not_serve():
    """A launch needs a CUDA stream, which only a CUDA device has. Meta
    tensors (the dry run) take the CUDA route's checks and allocations and
    launch nothing."""
    from repro_torch.kernels import build
    from repro_torch.kernels import qsgd as K
    from repro_torch.kernels import topk as T

    with pytest.raises(ValueError, match="CUDA or CPU"):
        build.cuda_stream(torch.device("meta"))
    x = torch.zeros(2, 256, device="meta")
    launches = (K.qsgd_quantize.launches, T.topk_select_pack.launches,
                T.topk_scatter_accum.launches)
    levels, norms = K.qsgd_quantize(x, x, 7)
    vals, idx = T.topk_select_pack(x[0], 3)
    out = T.topk_scatter_accum(x, torch.zeros(2, 256, dtype=torch.int32, device="meta"),
                               torch.ones(2, device="meta"), 9)
    assert (levels.dtype, levels.shape, norms.shape) == (torch.int8, x.shape, (2,))
    assert (vals.shape, idx.dtype, out.shape, out.device.type) == ((3,), torch.int32, (9,), "meta")
    assert (K.qsgd_quantize.launches, T.topk_select_pack.launches,
            T.topk_scatter_accum.launches) == launches
    with pytest.raises(ValueError, match="must be a 2-d"):
        K.qsgd_quantize(x[0], x[0], 7)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout

"""The port's train CLI (``repro_torch.launch.train``) against the
reference's ``repro/launch/train.py``, on the CPU.

Both CLIs start from one state: the reference's trainer writes reduced
qwen2.5-3b's init state (``test_torch_train_steps.fill_params``'s weights)
and both ``--restore`` it. The reference runs each command line on a
2-device host mesh in one subprocess, the port in this process with
``--device cpu`` added:

* the printed lines: the same lines in the same order; the mesh, graph,
  exchange, shard plan and checkpoint lines identical, each step's lr
  identical and its loss and ce (peer 0's, reference behaviour 21) within
  3e-4 of the reference's printed value (``reduced`` keeps bf16 compute
  on both sides: 1.5e-4 measured at step 3); the accounting lines carry
  measured times and are compared up to their first colon;
* a checkpoint written by one CLI (``--checkpoint``) is ``--restore``d by the
  other, and read by the port's serve twin (``--checkpoint``), v2 states
  and the reference's v1 params;
* reference behaviour 21: the port prints row 0 of the step's ``(P,)``
  ``aux``, which differs from row 1;
* ``--data-parallel 2 --model-parallel 2``: the reference's CLI on a
  4-host-device mesh (2 peers x 2 Lambda slots) prints the same lines,
  the mesh line identical, loss and ce within 3e-4; in the port the Lambda
  slots are stacked on the one card, so ``--model-parallel 2`` gives the
  bits of ``--model-parallel 1``.
"""
import inspect
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.examples import p2p_serverless_train
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.train import P2PTrainer
from test_torch_train_steps import fill_params

torch.set_num_threads(2)  # the test workers share the CPU with each other

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
COMMON = ["--steps", "3", "--batch", "4", "--seq", "16", "--log-every", "1",
          "--data-parallel", "2"]
RUNS = {
    "mean": COMMON + ["--serverless-report", "--cost-report"],
    "sharded": COMMON + ["--exchange", "reduce_scatter", "--serverless-report"],
}

REFERENCE = inspect.getsource(fill_params) + textwrap.dedent(
    """
    import contextlib, io, os, sys
    import jax
    from repro import compat
    from repro.configs import get_config, reduced
    from repro.core.p2p import Topology
    from repro.launch import train
    from repro.optim import adam
    from repro.train import P2PTrainer
    from repro.train import checkpoint as ck

    out, runs = sys.argv[1], eval(sys.argv[2])
    cfg = reduced(get_config("qwen2.5-3b"), vocab_size=512)
    mesh = compat.make_mesh((1,), ("data",), axis_types=(compat.AxisType.Auto,))
    trainer = P2PTrainer(cfg, adam(), Topology(peer_axes=(), lambda_axis=None), mesh, lambda s: 0.0)
    state = trainer.init_state(jax.random.PRNGKey(0))
    state = state.replace(params=fill_params(cfg), opt_state=adam().init(fill_params(cfg)))
    trainer.save(os.path.join(out, "init"), state)
    ck.save(os.path.join(out, "params_v1"), state.params, step=5)
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(argv + ["--restore", os.path.join(out, "init"),
                               "--checkpoint", os.path.join(out, name)])
        with open(os.path.join(out, name + ".log"), "w") as f:
            f.write(buf.getvalue())
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out), repr(RUNS)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return out


STEP = re.compile(r"step +(\d+) loss (\S+) ce (\S+) lr (\S+) \(")


def _port_run(capsys, argv):
    capsys.readouterr()
    ttrain.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _same_lines(ours: str, theirs: str) -> None:
    ours, theirs = ours.splitlines(), theirs.splitlines()
    assert len(ours) == len(theirs), (ours, theirs)
    for a, b in zip(ours, theirs):
        ma, mb = STEP.match(a), STEP.match(b)
        if mb:
            assert ma and ma.group(1) == mb.group(1) and ma.group(4) == mb.group(4), (a, b)
            for i in (2, 3):
                want = float(mb.group(i))
                assert abs(float(ma.group(i)) - want) <= 3e-4 * abs(want), (a, b)
        elif "accounting" in b or "frontier" in b or "aggregation:" in b:
            assert a.split(":")[0] == b.split(":")[0], (a, b)
        elif b.startswith("saved checkpoint"):
            assert a.startswith("saved checkpoint to ")
        else:
            assert a == b


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cli_prints_the_reference_lines(reference, capsys, tmp_path, run):
    ours = _port_run(capsys, RUNS[run] + ["--restore", str(reference / "init"),
                                          "--checkpoint", str(tmp_path / run)])
    theirs = (reference / f"{run}.log").read_text()
    assert "exchange=" in theirs and "restored checkpoint" in theirs
    _same_lines(ours, theirs)


def test_checkpoints_cross_between_the_clis(reference, capsys, tmp_path):
    # the reference's 2-peer state after 3 steps, resumed by the port
    out = _port_run(capsys, ["--steps", "1", "--batch", "4", "--seq", "16", "--data-parallel", "2",
                             "--restore", str(reference / "mean"),
                             "--checkpoint", str(tmp_path / "port")])
    assert f"restored checkpoint from {reference / 'mean'} (step 3)" in out
    # the port's state (step 4), resumed by the reference's single worker
    capsys.readouterr()
    jtrain.main(["--steps", "1", "--batch", "4", "--seq", "16",
                 "--restore", str(tmp_path / "port")])
    assert f"restored checkpoint from {tmp_path / 'port'} (step 4)" in capsys.readouterr().out


def _serve(capsys, *extra):
    capsys.readouterr()
    gen = serve.main(["--device", "cpu", "--arch", "qwen2.5-3b", "--gen", "3", "--batch", "2",
                      *extra])
    return gen, capsys.readouterr().out


def test_serve_reads_either_packages_checkpoint(reference, capsys, tmp_path):
    fresh, _ = _serve(capsys)
    v1, out = _serve(capsys, "--checkpoint", str(reference / "params_v1"))
    assert "restored checkpoint (step 5)" in out
    init, out = _serve(capsys, "--checkpoint", str(reference / "init"))
    assert "restored checkpoint (step 0)" in out
    assert np.array_equal(v1, init) and not np.array_equal(v1, fresh)
    # the port's v2 state written from the reference's init
    _port_run(capsys, ["--steps", "0", "--batch", "4", "--seq", "16",
                       "--restore", str(reference / "init"), "--checkpoint", str(tmp_path / "p")])
    ported, out = _serve(capsys, "--checkpoint", str(tmp_path / "p"))
    assert "restored checkpoint (step 0)" in out and np.array_equal(ported, init)


def test_ce_is_peer_zeros_aux(capsys, monkeypatch):
    """Reference behaviour 21: the step returns each peer's ce; the CLI
    prints peer 0's, as the reference's replicated aux reads."""
    seen = []
    step = P2PTrainer.step
    monkeypatch.setattr(P2PTrainer, "step", lambda self, s, b: _record(step, self, s, b, seen))
    out = _port_run(capsys, ["--steps", "1", "--batch", "4", "--seq", "16", "--data-parallel", "2"])
    aux = seen[0]["aux"]
    assert aux.shape == (2,) and float(aux[0]) != float(aux[1])
    assert f"ce {float(aux[0]):.4f} " in out


def _record(step, self, state, batch, seen):
    state, metrics = step(self, state, batch)
    seen.append(metrics)
    return state, metrics


MODEL_PARALLEL = COMMON + ["--model-parallel", "2"]
REFERENCE_MP = textwrap.dedent(
    """
    import contextlib, io, os, sys
    from repro.launch import train

    out, argv = sys.argv[1], eval(sys.argv[2])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv + ["--restore", os.path.join(out, "init"),
                           "--checkpoint", os.path.join(out, "model_parallel")])
    with open(os.path.join(out, "model_parallel.log"), "w") as f:
        f.write(buf.getvalue())
    print("OK")
    """
)


@pytest.fixture(scope="module")
def reference_model_parallel(reference):
    """The reference CLI's lines for ``MODEL_PARALLEL`` on 4 host devices
    (2 peers x 2 Lambda slots), from the ``reference`` fixture's init."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE_MP, str(reference), repr(MODEL_PARALLEL)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]
    return (reference / "model_parallel.log").read_text()


def test_model_parallel_prints_the_reference_lines(reference, reference_model_parallel, capsys,
                                                   tmp_path):
    ours = _port_run(capsys, MODEL_PARALLEL + ["--restore", str(reference / "init"),
                                               "--checkpoint", str(tmp_path / "mp")])
    assert "mesh={'data': 2, 'model': 2} peers=2" in reference_model_parallel
    _same_lines(ours, reference_model_parallel)


def test_model_parallel_changes_no_number(capsys):
    """The Lambda slots are stacked on the one card: two steps with 2 slots
    a peer give the params of two steps with 1, bit for bit."""
    argv = ["--steps", "2", "--batch", "4", "--seq", "16", "--data-parallel", "2"]
    one = ttrain.main(argv + ["--device", "cpu", "--model-parallel", "1"])
    two = ttrain.main(argv + ["--device", "cpu", "--model-parallel", "2"])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2} peers=2" in out
    assert one.params.keys() == two.params.keys()
    assert all(torch.equal(one.params[k], two.params[k]) for k in one.params)


def test_example_twin_runs_on_the_cpu(capsys, tmp_path):
    p2p_serverless_train.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8",
                               "--checkpoint", str(tmp_path / "ex")])
    out = capsys.readouterr().out
    assert "model: qwen-100m (100.9M params), peers=1, exchange=qsgd" in out
    assert "step    1  ce=" in out and (tmp_path / "ex.npz").exists()

"""The port's mesh and sharding rules (``repro_torch.launch.mesh``,
``launch.sharding``) and the dry run's copied rules (``SKIPS``,
``cfg_for_shape``, ``topology_for``) against the reference's, on the CPU.

* ``make_production_mesh``'s axis sizes are the reference's meshes' (built
  in a subprocess on 512 host devices);
* ``param_specs`` gives, leaf for leaf, the reference's ``param_shardings``
  specs for every arch of its ``ASSIGNED_ARCHS``: the port's meta params
  mapped through ``convert.lm_jax_shapes`` to the reference's paths and
  layouts (which must be the reference's ``eval_shape`` tree), on
  ``tests/test_launch.py``'s fake single- and multi-pod meshes;
* ``activation_rules``, ``batch_specs`` and ``decode_state_specs`` equal
  the reference's for every arch x shape;
* the dry run's ``SKIPS``, ``ASSIGNED_ARCHS``, ``cfg_for_shape``, and
  ``topology_for``'s peers and regimes equal the reference's.

The reference's ``NamedSharding`` is replaced by its spec (the fake meshes
hold no devices); its dry-run module is imported with ``XLA_FLAGS`` put
back, so that it forces no host devices on the tests that follow.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import ASSIGNED_ARCHS, SHAPES, get_config as jget_config
from repro.launch import sharding as JSH
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

jax.devices()  # the backend starts before the reference's dry run edits XLA_FLAGS
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


class FakeMesh:  # tests/test_launch.py's
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)


def _path(path) -> str:
    return "/".join(JSH._path_keys(path))


def test_production_mesh_sizes_are_the_references():
    code = ("from repro.launch.mesh import make_production_mesh as m\n"
            "print(dict(m().shape), dict(m(multi_pod=True).shape))")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[0] == f"{make_production_mesh()} {make_production_mesh(multi_pod=True)}"
    assert make_production_mesh() == MESHES["single"]
    assert make_production_mesh(multi_pod=True) == MESHES["multi"]
    assert make_host_mesh(2, 4) == {"data": 2, "model": 4}


def test_dryrun_copies_are_the_references():
    assert TD.SKIPS == JD.SKIPS
    assert TD.ASSIGNED_ARCHS == ASSIGNED_ARCHS
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES.values():
            ours = TD.cfg_for_shape(get_config(arch), shape)
            theirs = JD.cfg_for_shape(jget_config(arch), shape)
            assert (ours.serve_window, ours.sliding_window) == (theirs.serve_window,
                                                                theirs.sliding_window)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_topology_for_peers_and_regimes(mesh):
    fake = FakeMesh(MESHES[mesh])
    for arch in ASSIGNED_ARCHS:
        ref = JD.topology_for(jget_config(arch), fake, exchange="qsgd", exchange_dtype="bfloat16",
                              cast_params_once=True)
        ours = TD.topology_for(get_config(arch), MESHES[mesh], exchange="qsgd",
                               exchange_dtype="bfloat16", cast_params_once=True)
        assert TD.peer_axes(get_config(arch), MESHES[mesh]) == ref.peer_axes
        assert TD.peer_count(get_config(arch), MESHES[mesh]) == int(
            np.prod([MESHES[mesh][a] for a in ref.peer_axes]))
        assert TD.regime(get_config(arch)) == ("serverless" if ref.serverless else "fsdp")
        assert (ours.exchange, ours.exchange_dtype, ours.cast_params_once) == (
            ref.exchange, ref.exchange_dtype, ref.cast_params_once)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_are_the_references(arch, spec_only):
    cfg, jcfg = get_config(arch), jget_config(arch)
    tree = jax.eval_shape(lambda: jmodels.init_model(jax.random.PRNGKey(0), jcfg))
    theirs_shapes = {_path(p): tuple(x.shape)
                     for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    model = TD.meta_model(cfg)
    shapes = convert.lm_jax_shapes({k: tuple(p.shape) for k, p in model.named_parameters()}, cfg)
    assert shapes == theirs_shapes
    for name, mesh in MESHES.items():
        specs = JSH.param_shardings(tree, jcfg, FakeMesh(mesh))
        theirs = {_path(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        assert SH.param_specs(shapes, cfg, mesh) == theirs, name
    # an optimizer moment takes its parameter's spec
    opt = {f"mu/{k}": s for k, s in shapes.items()}
    ours = SH.param_specs(opt, cfg, MESHES["single"])
    assert all(ours[f"mu/{k}"] == v for k, v in SH.param_specs(shapes, cfg, MESHES["single"]).items())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_activation_rules_and_batch_specs_are_the_references(arch, spec_only):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, mesh in MESHES.items():
        fake = FakeMesh(mesh)
        for shape in SHAPES.values():
            peer_axes = TD.peer_axes(cfg, mesh)
            rules = SH.activation_rules(cfg, shape, mesh, peer_axes=peer_axes)
            theirs = JSH.activation_rules(jcfg, shape, fake, peer_axes=peer_axes)
            assert rules == theirs, (name, shape.name)
            if shape.mode == "decode":
                continue
            leaves, specs = SH.batch_specs(cfg, shape, mesh, rules)
            jleaves, jspecs = JSH.batch_specs(jcfg, shape, fake, theirs)
            assert specs == {k: tuple(v) for k, v in jspecs.items()}, (name, shape.name)
            assert {k: s for k, (s, _) in leaves.items()} == {
                k: tuple(v.shape) for k, v in jleaves.items()}


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma2-2b", "zamba2-1.2b", "whisper-base"])
def test_decode_state_specs_are_the_references(arch, spec_only):
    """The port keeps each layer's cache or SSM state in layer order (the
    reference stacks each slot's, or whisper's self and cross caches, on a
    leading axis): each leaf's spec is the trailing part of the reference's
    for its stack (``layers``, ``self``, ``cross``) and kind of leaf."""
    from repro_torch import models

    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh, shape = MESHES["single"], SHAPES["decode_32k"]
    cfg = TD.cfg_for_shape(cfg, shape)
    jcfg = JD.cfg_for_shape(jcfg, shape)
    rules = SH.activation_rules(cfg, shape, mesh)
    state = models.init_decode_state(cfg, 128, 64, device="meta")
    ours = {k: t for k, t in SH.flat_leaves(state).items() if isinstance(t, torch.Tensor)}
    specs = SH.flat_leaves(SH.decode_state_specs(state, cfg, mesh, rules))
    jstate = jax.eval_shape(lambda: jmodels.init_decode_state(jcfg, 128, 64))
    jspecs = JSH.decode_state_shardings(jstate, jcfg, FakeMesh(mesh), rules)
    theirs = {}
    for p, s in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        keys = JSH._path_keys(p)
        theirs.setdefault((keys[0], keys[-1]), set()).add(tuple(s))
    assert ours, arch
    for key, t in ours.items():
        parts = key.split("/")
        want = theirs[(parts[0], parts[-1])]
        assert {x[-t.dim():] for x in want} == {specs[key]}, (key, want)


def test_shard_factor_and_per_chip_bytes():
    mesh = MESHES["multi"]
    assert SH.shard_factor((("pod", "data"), "model"), mesh) == 512
    assert SH.shard_factor((None, "model"), mesh) == 16
    assert SH.shard_factor((), mesh) == 1
    got = SH.per_chip_bytes({"a": (1024, 4), "b": (10, 2)}, {"a": ("data",)}, mesh)
    assert got == 1024 * 4 / 16 + 10 * 2

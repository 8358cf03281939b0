"""The H100 dry run (``repro_torch.launch.dryrun``) and its counting mode
(``launch.op_analysis``), on the CPU and the meta device.

* Matrix-product FLOPs against the reference's HLO analyzer: reduced
  mamba2-370m's scoring forward counted on meta equals
  ``repro.launch.hlo_analysis.analyze`` of the reference's jitted forward on
  one CPU device (measured: exactly); its train step (Adam, one worker)
  equals the reference's step plus the port's chunked head's one extra
  product, the logits computed again in its backward (2 N d V_pad), within
  1 % (measured: 0.082 % below; without the head's term 6.9 % above at
  these widths, where the head is a quarter of the work).
* Remat: reduced gemma2-2b's step with ``remat`` counts exactly one more
  forward of its layers than without.
* The flash cost functions against a brute-force count of the pairs that
  the kernels' mask keeps: causal, windowed, non-causal and cross.
* ``kernels/cost.py`` loads by its path alone and holds the functions
  that the kernel modules charge.
* Peak live bytes, and the ops whose storages make the peak, on a
  hand-built sequence of allocations, views and frees.
* Full-size combinations of the reference's matrix, one per mode, on meta:
  the reference's record keys and the added ones, the kernels charged.
* The CLI on one combination; ``--all`` (39 ok, 1 skipped) takes about 13
  minutes on meta and is run by hand (PERF.md).
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import compat
from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.p2p import Topology as JTopology
from repro.launch import hlo_analysis
from repro.optim import adam as jadam
from repro.train.steps import build_train_step as jbuild_train_step
from repro.train.steps import init_train_state as jinit_train_state
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.kernels import flash_attention as kf
from repro_torch.launch import dryrun as D
from repro_torch.launch.op_analysis import OpCount, block_bytes
from repro_torch.models.transformer import layer_grouping

B, S = 2, 64
RECORD_KEYS = {"arch", "shape", "mesh", "mode", "exchange", "peers", "moe_dispatch", "chips",
               "hlo_flops", "hlo_bytes", "collective_bytes", "collectives", "terms_s", "dominant",
               "model_flops", "useful_flops_ratio", "memory", "op_bytes", "fits",
               "per_chip_argument_bytes", "regime"}


@pytest.fixture(scope="module")
def mamba():
    return reduced(get_config("mamba2-370m")), jreduced(jget_config("mamba2-370m"))


def test_forward_flops_equal_the_reference_analyzer(mamba):
    cfg, jcfg = mamba
    params = jmodels.init_model(jax.random.PRNGKey(0), jcfg)
    toks = jnp.zeros((B, S), jnp.int32)
    compiled = jax.jit(lambda p, b: jmodels.forward(p, b, jcfg)[0]).lower(
        params, {"tokens": toks}).compile()
    theirs = hlo_analysis.analyze(compiled.as_text()).flops
    count, _ = D.count_forward(D.meta_model(cfg), D.meta_batch(cfg, B, S, labels=False), cfg)
    assert theirs > 0 and abs(count.ops.flops / theirs - 1) <= 0.01


def test_train_step_flops_equal_the_reference_analyzer(mamba):
    cfg, jcfg = mamba
    opt = jadam()
    state = jinit_train_state(jax.random.PRNGKey(0), jcfg, opt)
    toks = jnp.zeros((B, S), jnp.int32)
    mesh = compat.make_mesh((1,), ("data",), axis_types=(compat.AxisType.Auto,))
    step = jbuild_train_step(jcfg, opt, JTopology(peer_axes=(), lambda_axis=None), mesh,
                             lambda s: jnp.float32(1e-3))
    with compat.set_mesh(mesh):
        compiled = jax.jit(step).lower(state, {"tokens": toks, "labels": toks}).compile()
    theirs = hlo_analysis.analyze(compiled.as_text()).flops
    count, _, _ = D.meta_train(cfg, 1, B, S)
    head_again = 2 * B * S * cfg.d_model * cfg.padded_vocab  # ChunkedHeadFn's backward
    assert theirs > 0 and abs((count.ops.flops - head_again) / theirs - 1) <= 0.01


def test_remat_adds_one_forward_of_the_layers():
    cfg = reduced(get_config("gemma2-2b"), remat=True)
    plain = reduced(get_config("gemma2-2b"))
    period, groups, _ = layer_grouping(cfg)
    assert groups * len(period) == cfg.num_layers  # every layer in a remat group, no tail
    with_remat, _, _ = D.meta_train(cfg, 2, 1, S)
    without, _, _ = D.meta_train(plain, 2, 1, S)
    # the layers' forward alone: the model to final_norm (the embedding is
    # a gather), on the step's 2 x S tokens, with grad mode on as in training
    model = D.meta_model(plain).requires_grad_(True)
    batch = D.meta_batch(plain, 2, S, labels=False)
    c = OpCount()
    with c:
        model(batch["tokens"], plain, head=False)
    assert with_remat.ops.flops - without.ops.flops == c.flops > 0
    assert with_remat.ops.kernels["flash_attention"][0] == 2 * without.ops.kernels[
        "flash_attention"][0]


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (37, 37, True, 0), (37, 37, True, 8), (37, 37, False, 0), (20, 51, False, 0),
    (51, 20, True, 0), (64, 64, True, 64), (64, 64, True, 100), (5, 9, True, 3)])
def test_flash_cost_counts_the_kept_pairs(Sq, Skv, causal, window):
    i = torch.arange(Sq)[:, None]
    j = torch.arange(Skv)[None, :]
    keep = (i - j >= 0) & ((i - j < window) if window else True) if causal else (j >= 0) & (i >= 0)
    pairs = int(keep.sum())
    assert kf.valid_pairs(Sq, Skv, causal=causal, window=window) == pairs
    q = torch.empty((2, Sq, 6, 32), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, Skv, 3, 32), dtype=torch.bfloat16, device="meta")
    flops, nbytes = kf.flash_attention_cost(q, k, causal=causal, window=window)
    assert flops == 4 * 32 * 6 * 2 * pairs
    assert nbytes == 2 * 2 * (q.numel() + k.numel())
    _, with_stats = kf.flash_attention_cost(q, k, causal=causal, window=window, stats=True)
    assert with_stats == nbytes + 4 * 2 * Sq * 6 * 32 + 4 * 2 * 6 * Sq
    bflops, bbytes = kf.flash_attention_backward_cost(q, k, causal=causal, window=window)
    assert bflops == 10 * 32 * 6 * 2 * pairs and bbytes == 2 * (3 * q.numel() + 4 * k.numel())


def test_flash_meta_route_charges_its_cost_without_a_launch():
    q = torch.empty((2, 40, 4, 64), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty((2, 40, 2, 64), dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    before = (kf.flash_attention.launches, kf.flash_attention_backward.launches)
    c = OpCount()
    with c:
        o = kf.flash_attention(q, k, v, causal=True, window=16)
        o.backward(torch.empty_like(o))
    assert (kf.flash_attention.launches, kf.flash_attention_backward.launches) == before
    fwd = kf.flash_attention_cost(q, k, causal=True, window=16, stats=True)
    bwd = kf.flash_attention_backward_cost(q, k, causal=True, window=16)
    assert c.kernels == {"flash_attention": [1, *fwd], "flash_attention_backward": [1, *bwd]}
    assert q.grad.shape == q.shape and k.grad.device.type == "meta"


def test_cost_functions_load_by_path_alone():
    """``chip_smoke.py`` loads ``kernels/cost.py`` by its path beside
    another checkout's ``repro_torch``: it must import nothing, and the
    kernel modules charge the same functions."""
    import importlib.util
    import sys

    from repro_torch.kernels import causal_conv as kc
    from repro_torch.kernels import qsgd as kq
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.kernels import topk as kt

    path = os.path.join(os.path.dirname(kf.__file__), "cost.py")
    spec = importlib.util.spec_from_file_location("_cost_alone", path)
    cost = importlib.util.module_from_spec(spec)
    before = set(sys.modules)
    spec.loader.exec_module(cost)
    assert set(sys.modules) == before
    for mod, names in ((kf, ("valid_pairs", "flash_attention_cost", "flash_attention_backward_cost")),
                       (ks, ("ssd_scan_cost", "ssd_scan_bwd_cost")),
                       (kq, ("qsgd_quantize_cost", "qsgd_dequantize_cost",
                             "qsgd_dequant_reduce_cost")),
                       (kt, ("topk_select_cost", "topk_scatter_cost")),
                       (kc, ("causal_conv_cost", "causal_conv_bwd_cost"))):
        for name in names:
            assert getattr(mod, name).__code__.co_code == getattr(cost, name).__code__.co_code
    q = torch.empty((2, 64, 4, 32), dtype=torch.bfloat16, device="meta")
    assert cost.flash_attention_cost(q, q) == kf.flash_attention_cost(q, q)


def test_peak_tracks_storages_views_and_frees():
    f32 = dict(dtype=torch.float32, device="meta")
    held = torch.empty(300, **f32)  # 1,200 B: 3 blocks
    c = OpCount()
    with c:
        assert c.track({"x": held, "view": held[1:]}) == 1536
        a = torch.empty(1000, **f32)  # 4,000 B -> 4,096
        b = a[10:]  # a view: nothing new
        assert c.live == 1536 + 4096
        d = torch.empty(10, **f32)  # 40 B -> 512
        del a
        assert c.live == 1536 + 4096 + 512  # b keeps the storage
        del b
        assert c.live == 1536 + 512
        e = torch.empty(2000, **f32)  # 8,000 B -> 8,192
        e.add_(1)  # in place: nothing new
        f = e * 2  # 8,192 more
        del e, f
        g = torch.empty(0, **f32)
    assert c.peak == 1536 + 512 + 2 * 8192
    assert c.peak_parts == {("argument", 1536): 1, ("empty", 512): 1, ("empty", 8192): 1,
                            ("mul", 8192): 1}
    assert [(t["op"], t["bytes"]) for t in c.peak_top(2)] == [("empty", 8192), ("mul", 8192)]
    assert c.live == 1536 + 512 and block_bytes(0) == 0 and g.numel() == 0
    del d
    assert c.live == 1536


@pytest.mark.parametrize("arch,shape", [("mamba2-370m", "decode_32k"),
                                        ("whisper-base", "prefill_32k"),
                                        ("whisper-base", "train_4k")])
def test_full_size_combination_on_meta(arch, shape):
    rec = D.run_one(arch, shape, multi_pod=False, verbose=False)
    assert RECORD_KEYS <= set(rec), RECORD_KEYS - set(rec)
    assert rec["chips"] == 1 and rec["collective_bytes"] == 0
    assert rec["peers"] == 16 and rec["mesh"] == "16x16" and rec["mode"] == SHAPES[shape].mode
    assert set(rec["terms_s"]) == {"compute", "memory", "collective"}
    assert rec["hlo_flops"] > 0 and rec["op_bytes"] > rec["hlo_bytes"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 and rec["fits"] == (
        mem["peak_bytes"] <= 80e9)
    assert 0 < rec["per_chip_argument_bytes"] < mem["argument_bytes"]
    cfg = D.cfg_for_shape(get_config(arch), SHAPES[shape])
    assert rec["model_flops"] == D.model_flops(cfg, SHAPES[shape])
    if arch == "whisper-base":  # 6 encoder and 6 decoder layers, self and cross attention
        calls = rec["kernels"]["flash_attention"]["calls"]
        assert calls == (36 if shape == "train_4k" else 18)
        assert math.isclose(rec["useful_flops_ratio"], rec["model_flops"] / rec["hlo_flops"])


def test_cli_one_combination(tmp_path, capsys):
    out = tmp_path / "dry.json"
    D.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--json", str(out)])
    text = capsys.readouterr().out
    assert "OK mamba2-370m x long_500k" in text and text.rstrip().endswith("1 ok, 0 skipped, 0 failed")
    recs = json.loads(out.read_text())
    assert len(recs) == 1 and RECORD_KEYS <= set(recs[0])
    D.main(["--arch", "whisper-base", "--shape", "long_500k"])
    assert "SKIP whisper-base x long_500k" in capsys.readouterr().out

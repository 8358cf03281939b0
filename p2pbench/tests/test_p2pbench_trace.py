"""The trace reduction and the readers on made-up events: the busy time is
the union of the device's activities inside the window, each idle gap is
labelled by the innermost host operation at its middle, and a reader with
nothing to read returns None."""
import math
import types

import pytest

from p2pbench import costs, harness, readers
from p2pbench.exchanges import qsgd, topk
from p2pbench.families import lm


def test_busy_is_the_union_inside_the_window():
    dev = [("k1", 0.5, 2.0), ("k2", 1.5, 3.0), ("k3", 5.0, 6.0), ("k4", 9.0, 12.0)]
    host = [("outer", 0.0, 10.0), ("aten::mul", 3.5, 4.5), ("p2pbench.step", 0.0, 10.0)]
    t = harness.reduce_trace(dev, host, (1.0, 10.0))
    assert t["window_s"] == 9.0
    assert t["busy_s"] == (3.0 - 1.0) + (6.0 - 5.0) + (10.0 - 9.0)
    assert dict(t["breakdown"]["device_ops"]) == {"k1": 1.0, "k2": 1.5, "k3": 1.0, "k4": 1.0}
    # gaps (3, 5), middle 4.0 inside aten::mul; (6, 9), middle 7.5 inside outer only
    assert dict(t["breakdown"]["idle_gaps"]) == {"aten::mul": 2.0, "outer": 3.0}


def test_readers_return_none_without_a_trace():
    ctx = types.SimpleNamespace(family=lm, trace=None, launches=None,
                                cell={"exchange": {"name": "qsgd"}})
    assert readers.idle_pct(ctx) is None
    assert readers.codec_s_per_step(ctx) is None
    ctx.cell = {"exchange": {"name": "allgather_mean"}}
    ctx.trace = {"kernels": [("quantize_kernel", 0.0, 1.0)], "steps": 1}
    assert readers.codec_s_per_step(ctx) is None  # the mean names no kernel of its own


LEAVES = {"fc2.weight": (4096, 4096), "fc2.bias": (4096,)}


@pytest.mark.parametrize("exchange", [
    {"name": "qsgd", "levels": 127, "bucket": 2048, "ef": True},
    {"name": "topk", "frac": 0.01, "ef": True},
])
def test_codec_bound_sums_each_leaf_of_what_launched(exchange):
    names = {"qsgd": ("qsgd_quantize", "qsgd_dequant_reduce", "qsgd_dequantize"),
             "topk": ("topk_select_pack", "topk_scatter_accum")}[exchange["name"]]
    ctx = types.SimpleNamespace(costs=costs, leaves=LEAVES, cell={"peers": 4, "exchange": exchange},
                                launches=dict.fromkeys(names, 2.0))
    total = 0.0
    for shape in LEAVES.values():
        n = math.prod(shape)
        if exchange["name"] == "qsgd":
            nb = -(-n // 2048)
            parts = [costs.qsgd_quantize_cost(4 * nb, 2048), costs.qsgd_dequant_reduce_cost(4, nb, 2048),
                     costs.qsgd_dequantize_cost(4 * nb, 2048)]
        else:
            k = topk.k_of(n, exchange)
            parts = [costs.topk_select_cost(4, n, k), costs.topk_scatter_cost(4, k, 1, n, own=True)]
        total += sum(costs.bound_s(f, b, costs.PEAK_FLOPS_FP32) for f, b in parts)
    assert readers.codec_bound_s(ctx) == pytest.approx(total, rel=1e-12) and total > 0
    ctx.launches = dict.fromkeys(names, 0.0)  # nothing launched: no bound
    assert readers.codec_bound_s(ctx) == 0.0


def test_kernel_symbols_of_the_exchanges():
    assert qsgd.KERNELS.search("(anonymous namespace)::dequant_reduce_kernel(signed char)")
    assert topk.KERNELS.search("void select_row_kernel<256>(float const*)")
    assert not qsgd.KERNELS.search("at::native::elementwise_kernel<128>")
    assert not topk.KERNELS.search("quantize_kernel")


def test_counters_are_every_kernel_wrappers():
    found = harness.read_counters()
    assert {"qsgd_quantize", "qsgd_dequantize", "qsgd_dequant_reduce", "topk_select_pack",
            "topk_scatter_accum", "flash_attention", "flash_attention_backward",
            "ssd_scan"} <= set(found)
    assert all(isinstance(v, int) for v in found.values())

"""QSGD with ``levels`` and ``bucket``: the port's quantize, dequantize and
dequantize-and-reduce kernels (``kernels/qsgd.py``)."""
import re

# the symbols of the codec's kernels in the trace (``kernels/csrc/qsgd.cu``)
KERNELS = re.compile(r"\b(quantize_kernel|dequantize_kernel|dequant_reduce_kernel)\b")


def topology(ex: dict) -> dict:
    from repro_torch.core import QSGDConfig

    return {"exchange": "qsgd", "ef": bool(ex.get("ef", False)),
            "qsgd": QSGDConfig(ex["levels"], ex["bucket"])}


def bound_s(costs, peers: int, n: int, ex: dict, ran) -> float:
    """The quantize of every peer's buckets, the dequantize-and-reduce into
    the mix and (error feedback) the dequantize of the peers' own images."""
    nb = -(-n // ex["bucket"])
    parts = []
    if "qsgd_quantize" in ran:
        parts.append(costs.qsgd_quantize_cost(peers * nb, ex["bucket"]))
    if "qsgd_dequant_reduce" in ran:
        parts.append(costs.qsgd_dequant_reduce_cost(peers, nb, ex["bucket"]))
    if "qsgd_dequantize" in ran:
        parts.append(costs.qsgd_dequantize_cost(peers * nb, ex["bucket"]))
    return sum(costs.bound_s(f, b, costs.PEAK_FLOPS_FP32) for f, b in parts)

"""Top-k at ``frac`` of each leaf's entries: the port's select-and-pack and
scatter-accumulate kernels (``kernels/topk.py``)."""
import re

# the symbols of the codec's kernels in the trace (``kernels/csrc/topk.cu``)
KERNELS = re.compile(r"\b(select_row_kernel|select_grid_kernel|scatter_tile_kernel|"
                     r"scatter_bucket_kernel|scatter_gather_kernel)\b")


def k_of(n: int, ex: dict) -> int:
    return max(1, min(n, int(round(n * ex["frac"]))))


def topology(ex: dict) -> dict:
    return {"exchange": "topk", "ef": bool(ex.get("ef", False)), "topk_frac": ex["frac"]}


def bound_s(costs, peers: int, n: int, ex: dict, ran) -> float:
    """The select over the peers' rows and the scatter into the mix and
    (error feedback) the own images."""
    k, parts = k_of(n, ex), []
    if "topk_select_pack" in ran:
        parts.append(costs.topk_select_cost(peers, n, k))
    if "topk_scatter_accum" in ran:
        parts.append(costs.topk_scatter_cost(peers, k, 1, n, own=bool(ex.get("ef"))))
    return sum(costs.bound_s(f, b, costs.PEAK_FLOPS_FP32) for f, b in parts)

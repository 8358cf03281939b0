"""The plain f32 mean of the peers' gradients: no codec, no kernel of its own."""

KERNELS = None  # symbols of the codec's kernels in the trace


def topology(ex: dict) -> dict:
    return {"exchange": "allgather_mean", "ef": bool(ex.get("ef", False))}


def bound_s(costs, peers: int, n: int, ex: dict, ran) -> float:
    return 0.0

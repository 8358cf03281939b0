"""The yardstick's arithmetic, frozen here so that it cannot move when the
program changes: each hand-written kernel's least cost per call (copied
from the port's ``kernels/cost.py``: each input read once, each output
written once, the function's operations), the H100 SXM's published peaks
(copied from ``launch/mesh.py``), and the model FLOPs of a training step:
for a Mamba-2 LM, the dry run's ``6 N D`` with N the parameters as
``ModelConfig`` counts them, plus 3x the forward FLOPs of the SSD's
chunked products; for a CNN, 3x its forward FLOPs.

Shapes only: this module imports nothing.
"""

PEAK_FLOPS_BF16 = 989.4e12  # FLOP/s, dense, on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, outside the tensor cores
HBM_BW = 3.35e12  # bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time of a call: the larger of its operations at the peak
    rate and its bytes at the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BW)


# flash attention: q (B, Sq, H, D) and k (B, Skv, K, D) as shape tuples, with
# the element size of their dtype


def valid_pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0) -> int:
    if not causal:
        return Sq * Skv
    c = min(Skv, window) if window else Skv
    if Sq <= c:
        return Sq * (Sq + 1) // 2
    return c * (c + 1) // 2 + (Sq - c) * c


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flash_attention_cost(q, k, itemsize: int, *, causal: bool = True, window: int = 0,
                         stats: bool = False):
    """(FLOPs, bytes) of one forward: 4 D H B operations a valid pair; q, k, v
    read, o written, and with ``stats`` o in f32 and the row lse too."""
    B, Sq, H, D = q
    nbytes = 2 * _numel(q) * itemsize + 2 * _numel(k) * itemsize
    if stats:
        nbytes += 4 * B * Sq * H * D + 4 * B * H * Sq
    return 4 * D * H * B * valid_pairs(Sq, k[1], causal=causal, window=window), nbytes


def flash_attention_backward_cost(q, k, itemsize: int, *, causal: bool = True, window: int = 0):
    """(FLOPs, bytes) of one backward: five products, 10 D H B operations a
    valid pair; q, k, v, do read and dq, dk, dv written."""
    B, Sq, H, D = q
    nbytes = 3 * _numel(q) * itemsize + 4 * _numel(k) * itemsize
    return 10 * D * H * B * valid_pairs(Sq, k[1], causal=causal, window=window), nbytes


# QSGD over rows of ``bucket`` f32 entries


def qsgd_quantize_cost(rows: int, bucket: int):
    n = rows * bucket
    return 13 * n, 9 * n + 4 * rows


def qsgd_dequantize_cost(rows: int, bucket: int):
    n = rows * bucket
    return n + rows, 5 * n + 4 * rows


def qsgd_dequant_reduce_cost(peers: int, rows: int, bucket: int):
    n = rows * bucket
    return 2 * peers * n + 2 * peers * rows, peers * n + 4 * peers * rows + 4 * peers + 4 * n


# the top-k select and scatter


def topk_select_cost(rows: int, n: int, k: int):
    return 0, rows * (4 * n + 8 * k)


def topk_scatter_cost(peers: int, k: int, mixes: int, n: int, own: bool = False):
    nbytes = 8 * peers * k + (4 * peers * k if own else 0) + 4 * mixes * peers + 4 * (
        mixes + (peers if own else 0)) * n
    return 2 * peers * k * (mixes + (1 if own else 0)), nbytes


# model FLOPs


def lm_param_count(m: dict) -> int:
    """``ModelConfig.param_count`` of a Mamba-2 LM (the ``ssm`` family) of a
    configuration file's ``model``: the embedding (and an untied head), and
    each layer's mixer with 2 d of norms, as ``ModelConfig`` counts them."""
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    H, N, G = di // m["ssm_headdim"], m["ssm_state"], m["ssm_ngroups"]
    mamba = d * (2 * di + 2 * G * N + H) + m["ssm_conv"] * (di + 2 * G * N) + di * d + 2 * H + di
    head = m["vocab_size"] * d * (1 if m["tie_embeddings"] else 2)
    return head + m["num_layers"] * (2 * d + mamba)


def ssd_forward_flops_per_token(m: dict) -> int:
    """The chunked SSD's products for one token of one Mamba-2 layer, at the
    configuration's chunk Q (arXiv:2405.21060, section 6): C B^T within the
    chunk (2 Q G N), its scores times x (2 Q H P), the chunk's state (2 H P
    N) and the state read out by C (2 H P N)."""
    di = m["ssm_expand"] * m["d_model"]
    Q, G, N = m["ssm_chunk"], m["ssm_ngroups"], m["ssm_state"]
    return 2 * Q * G * N + 2 * Q * di + 4 * di * N


def lm_train_flops(m: dict, tokens: int) -> float:
    """6 N D, plus 3x the SSD's forward products in every layer (remat's
    recomputation not counted)."""
    return (6.0 * lm_param_count(m) + 3.0 * m["num_layers"] * ssd_forward_flops_per_token(m)) * tokens


def cnn_train_flops(forward_flops_per_image: int, images: int) -> float:
    """Forward, and a backward of twice its FLOPs, over the images."""
    return 3.0 * forward_flops_per_image * images

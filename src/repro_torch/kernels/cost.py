"""Each hand-written kernel's cost: the (FLOPs, bytes) that one call needs
at least, each input read once and each output written once, and the
operations of the function. The kernel modules export these beside their
wrappers, which charge them after a launch on the card and in place of one
on the meta device (``launch.dryrun``); ``chip_smoke.py`` reckons every
kernel's bound from them. Shapes only: the module imports nothing, so it
can be loaded by its path alone.
"""


# flash attention: q (B, Sq, H, D) and k (B, Skv, K, D), tensors or
# anything with their shape, numel() and element_size()


def valid_pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs that the kernels' mask keeps: causal, query i
    keeps min(i + 1, Skv, window) keys (window 0: no window); not causal,
    all Sq x Skv."""
    if not causal:
        return Sq * Skv
    c = min(Skv, window) if window else Skv
    if Sq <= c:
        return Sq * (Sq + 1) // 2
    return c * (c + 1) // 2 + (Sq - c) * c


def flash_attention_cost(q, k, *, causal: bool = True, window: int = 0, stats: bool = False):
    """(FLOPs, bytes) of one forward call at least: two products over the
    valid pairs (``valid_pairs``), 4 D H B operations a pair; q, k and v read
    and o written once, and with ``stats`` o in f32 and lse written too (the
    bf16 forward outside ``torch.inference_mode()``)."""
    B, Sq, H, D = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    if stats:
        nbytes += 4 * B * Sq * H * D + 4 * B * H * Sq
    return 4 * D * H * B * valid_pairs(Sq, k.shape[1], causal=causal, window=window), nbytes


def flash_attention_backward_cost(q, k, *, causal: bool = True, window: int = 0):
    """(FLOPs, bytes) of one backward call at least: the function's five
    products (s, dp, dv, dq, dk) over the valid pairs, 10 D H B operations a
    pair; q, k, v and do read and dq, dk, dv written once."""
    B, Sq, H, D = q.shape
    nbytes = 3 * q.numel() * q.element_size() + 4 * k.numel() * k.element_size()
    return 10 * D * H * B * valid_pairs(Sq, k.shape[1], causal=causal, window=window), nbytes


# the SSD scan: x (B, S, H, P) and Bm (B, S, G, N), likewise


def ssd_scan_cost(x, Bm):
    """(FLOPs, bytes) of one scan at least: the per-step recurrence's 4 B S H
    P N operations (a multiply-add into the state and one out of it per
    state element and step); x, B and C in their dtype, dt (B, S, H) and A
    (H,) in f32 read once, y (B, S, H, P) f32 written once."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nbytes = (x.element_size() * Bsz * S * H * P + 4 * Bsz * S * H + 4 * H
              + 2 * Bm.element_size() * Bsz * S * G * N + 4 * Bsz * S * H * P)
    return 4 * Bsz * S * H * P * N, nbytes


def ssd_scan_bwd_cost(x, Bm, chunk: int):
    """(FLOPs, bytes) of one backward call at least: the per-step
    recurrence's backward, 8 B S H P N operations (the state's gradient
    carried back and the multiply-adds of dx, dB and dC against it, a
    multiply-add each per state element and step); x, B, C, the forward's
    entering states (B, chunks, H, 2, P, N) as bf16 hi and lo, dt, A and dy
    (B, S, H, P) in f32 read once; dx, dB, dC in their dtypes and ddt, dA in
    f32 written once."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunks = -(-S // chunk)
    nbytes = (2 * x.element_size() * Bsz * S * H * P + 4 * Bsz * S * H * P
              + 4 * Bm.element_size() * Bsz * S * G * N + 2 * 2 * Bsz * chunks * H * P * N
              + 2 * 4 * Bsz * S * H + 2 * 4 * H)
    return 8 * Bsz * S * H * P * N, nbytes


# Mamba-2's causal conv1d + bias + SiLU: x (B, S, C) and K taps


def causal_conv_cost(x, K: int):
    """(FLOPs, bytes) of one forward call at least: x read and y (B, S, C)
    written once in x's dtype, w (K, C) and b (C,) read once. Its 2K + 4
    operations an element (the taps' multiply-adds, the bias, SiLU) are
    elementwise, which the dry run's count of matrix-product FLOPs leaves
    out, as it does PyTorch's: 0 (the bound is by bytes)."""
    B, S, C = x.shape
    e = x.element_size()
    return 0, 2 * e * B * S * C + e * (K + 1) * C


def causal_conv_bwd_cost(x, K: int):
    """(FLOPs, bytes) of one backward call at least: x and dy read and dx
    written once in x's dtype, w and b read and dw and db written once. Its
    6K + 9 operations an element are elementwise: 0, as the forward's."""
    B, S, C = x.shape
    e = x.element_size()
    return 0, 3 * e * B * S * C + 2 * e * (K + 1) * C


# QSGD, for rows of ``bucket`` entries (n in all): the f32 operations


def qsgd_quantize_cost(rows: int, bucket: int):
    """buckets and u f32 read, levels int8 and norms f32 written; 13
    operations a value."""
    n = rows * bucket
    return 13 * n, 9 * n + 4 * rows


def qsgd_dequantize_cost(rows: int, bucket: int):
    """levels int8 and norms read, f32 written; a product a value and a
    division a row."""
    n = rows * bucket
    return n + rows, 5 * n + 4 * rows


def qsgd_dequant_reduce_cost(peers: int, rows: int, bucket: int):
    """P peers' levels and norms and the P weights read, the (rows, bucket)
    f32 mix written; a product and a sum a value and a peer, and two a row
    and a peer for the scales."""
    n = rows * bucket
    return 2 * peers * n + 2 * peers * rows, peers * n + 4 * peers * rows + 4 * peers + 4 * n


# the top-k select and scatter


def topk_select_cost(rows: int, n: int, k: int):
    """(FLOPs, bytes) of one select over (rows, n) at least: each entry read
    once (4 B) and the k values and indices of a row written once (8 B
    each pair); its compares are not counted (the bound is by bytes)."""
    return 0, rows * (4 * n + 8 * k)


def topk_scatter_cost(peers: int, k: int, mixes: int, n: int, own: bool = False):
    """(FLOPs, bytes) of one scatter launch at least: the P x k values and
    indices (and the unrounded values, with own rows) and the (M, P) weights
    read, every one of the M mixes (and P own rows) of n f32 written once;
    a multiply-add a pair and a row."""
    nbytes = 8 * peers * k + (4 * peers * k if own else 0) + 4 * mixes * peers + 4 * (
        mixes + (peers if own else 0)) * n
    return 2 * peers * k * (mixes + (1 if own else 0)), nbytes

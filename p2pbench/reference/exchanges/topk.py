"""Top-k: each peer's k = round(frac n) largest magnitudes kept, the rest
zero, then averaged."""
import torch


def combine(bank, ex: dict, generator):
    P, n = bank.shape
    k = max(1, min(n, int(round(n * ex["frac"]))))
    idx = torch.topk(bank.abs(), k, dim=1).indices
    own = torch.zeros_like(bank).scatter_(1, idx, bank.gather(1, idx))
    return own.mean(dim=0), own

"""QSGD: each leaf zero-padded to whole buckets of ``bucket`` entries, each
bucket's entries scaled by its norm to ``levels`` levels and rounded
stochastically (one uniform an entry, drawn per leaf as (peers, buckets,
bucket) from the codec's generator), then decoded and averaged."""
import torch


def combine(bank, ex: dict, generator):
    P, n = bank.shape
    s, bucket = ex["levels"], ex["bucket"]
    nb = -(-n // bucket)
    b = torch.nn.functional.pad(bank, (0, nb * bucket - n)).reshape(P, nb, bucket)
    u = torch.rand((P, nb, bucket), generator=generator, device=generator.device)
    norms = torch.sqrt(torch.sum(b * b, dim=-1))
    r = b.abs() / torch.clamp_min(norms, 1e-30)[..., None] * s
    low = torch.floor(r)
    lev = torch.clamp(low + (u < r - low).to(torch.float32), 0, s) * torch.sign(b)
    own = (lev * (norms / s)[..., None]).reshape(P, -1)[:, :n]
    return own.mean(dim=0), own

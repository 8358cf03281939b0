"""The plain LM reference against the definitions it follows, on the CPU:
the chunked SSD scan equals the recurrence it computes, whatever the
chunk, and a batch's loss is the mean of its rows' losses."""
import pytest
import torch

from p2pbench.reference import lm


def recurrence(x, dt, A, B, C):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, step by step."""
    n, S, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    h = torch.zeros(n, H, P, B.shape[3], dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("chunk", [4, 8, 32])
def test_chunked_ssd_is_the_recurrence(chunk):
    g = torch.Generator().manual_seed(2**31 + 11)
    n, S, H, P, G, N = 2, 24, 4, 3, 2, 5
    f64 = dict(generator=g, dtype=torch.float64)
    x, B, C = torch.randn(n, S, H, P, **f64), torch.randn(n, S, G, N, **f64), torch.randn(n, S, G, N, **f64)
    dt = torch.rand(n, S, H, **f64) * 0.5
    A = -torch.linspace(1.0, 4.0, H, dtype=torch.float64)
    got = lm.ssd(x, dt, A, B, C, chunk)
    assert torch.allclose(got, recurrence(x, dt, A, B, C), rtol=1e-10, atol=1e-10)


def test_batch_loss_is_the_mean_of_its_rows():
    config = {"model": dict(num_layers=2, d_model=32, vocab_size=100, ssm_state=8, ssm_expand=2,
                            ssm_headdim=16, ssm_ngroups=1, ssm_conv=4, ssm_chunk=8, norm_eps=1e-5,
                            tie_embeddings=True)}
    from p2pbench import harness

    params = harness.make_params(lm.param_spec(config), 2**31 + 13, "cpu")
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 100, (3, 21), generator=g)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    rows = [lm.loss(params, {k: v[r:r + 1] for k, v in batch.items()}, config) for r in range(3)]
    with torch.no_grad():
        assert float(lm.loss(params, batch, config)) == pytest.approx(float(sum(rows) / 3), rel=1e-6)

"""Byzantine-robust aggregation — combinators + the adversary model.

The port of the reference's ``repro/core/robust.py``. Two halves:

* **Robust combinators** — functions over a peer-stacked gradient bank
  (``{name: (P, ...)}`` tensors): coordinate-wise trimmed mean, coordinate
  median, Krum / multi-Krum distance scoring, and per-peer gradient-norm
  clipping. The registered ``trimmed_mean:f`` / ``median`` / ``krum[:m]``
  protocols of :mod:`repro_torch.core.exchange` wrap these, so the device
  step and the host cluster share one implementation of the estimators.

  The masked variants take a ``(P,)`` membership mask, so the same code
  serves the full mesh (every peer a member) and a sparse overlay, where
  each peer takes the order statistic over its closed neighbourhood (self
  + graph neighbours). Krum scores need the distances between all
  contributions and refuse sparse overlays (``requires_full_graph``).

* **Adversary model** — :class:`AdversarySpec`: a seeded attacker subset of
  the peers and the attack they mount (``sign_flip`` / ``scaled_noise`` /
  ``stale_replay``). The host cluster poisons attacker publishes; the device
  step replaces the attackers' rows of the gradient bank before the
  exchange. ``stale_replay`` re-publishes the attacker's previous epoch's
  payload and exists on the host path only.

The estimators follow the reference's arithmetic: sort with ``+inf`` in
place of non-members (NaN sorts last, as in ``jnp.sort``), a trim clamped
to ``(k - 1) // 2``, the kept values summed in row order from zero, the two
middle values averaged for the median, Krum distances from the Gram matrix
clamped at zero and ranked with a stable argsort. Krum's Gram matrix is a
sum of f32 dot products, which no TF32 setting touches. Noise is drawn
from a ``torch.Generator`` through :func:`draw_normals`, the one place this
module draws random numbers (the reference's ``jax.random.normal`` stream
cannot be reproduced; parity tests replace the function).

Breakdown points (fraction of Byzantine peers each estimator survives,
coordinate-wise unless noted):

==================  =====================================================
``trimmed_mean:f``  up to ``f`` per end — choose ``f >=`` attacker frac
``median``          < 1/2
``krum[:m]``        ``f <= (P - 3) / 2`` (vector-wise, by construction)
plain mean          0 — one unbounded coordinate destroys the aggregate
==================  =====================================================
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import jax_order, to_jax_layout, to_torch_layout

Bank = Mapping[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Bank helpers: a "bank" is a {name: (P, ...)} dict — one row per peer
# ---------------------------------------------------------------------------


def bank_peer_norms(bank: Bank) -> torch.Tensor:
    """Per-peer global gradient norm across the whole bank: ``(P,)`` f32,
    the leaves' squared sums added in JAX leaf order."""
    sq = None
    for name in jax_order(bank):
        leaf = bank[name].to(torch.float32)
        s = (leaf * leaf).sum(dim=tuple(range(1, leaf.dim()))) if leaf.dim() > 1 else leaf * leaf
        sq = s if sq is None else sq + s
    if sq is None:
        raise ValueError("empty gradient bank")
    return torch.sqrt(sq)


def clip_bank_to_norm(bank: Bank, max_norm) -> Dict[str, torch.Tensor]:
    """Per-peer gradient-norm clipping: rescale every peer row whose global
    norm exceeds ``max_norm``. Bounds the damage of one scaled-up
    contribution before the estimator sees it."""
    norms = bank_peer_norms(bank)
    scale = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return {
        k: x.to(torch.float32) * scale.reshape(x.shape[0], *([1] * (x.dim() - 1)))
        for k, x in bank.items()
    }


def clip_bank_to_median_norm(bank: Bank) -> Dict[str, torch.Tensor]:
    """Clip every peer row to the median of the per-peer norms — the
    self-calibrating variant (no magnitude hyperparameter)."""
    norms = bank_peer_norms(bank)
    return clip_bank_to_norm(bank, masked_median(norms, torch.ones_like(norms, dtype=torch.bool)))


# ---------------------------------------------------------------------------
# Coordinate-wise order statistics (masked: one code path for the full mesh
# and sparse-graph closed neighbourhoods)
# ---------------------------------------------------------------------------


def _sorted_members(x: torch.Tensor, mask):
    """``x`` f32 sorted along dim 0 with ``+inf`` in place of non-member
    rows, and the member count ``k``."""
    m = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask, dtype=bool).reshape(-1)
    xs = x.to(torch.float32)
    if not m.all():
        col = torch.as_tensor(m, device=x.device).reshape(x.shape[0], *([1] * (x.dim() - 1)))
        xs = torch.where(col, xs, float("inf"))
    return torch.sort(xs, dim=0).values, int(m.sum())


def masked_trimmed_mean(x: torch.Tensor, mask, trim_frac: float) -> torch.Tensor:
    """Coordinate-wise trimmed mean of ``x[(P, ...)]`` over ``mask[(P,)]``.

    Sorts each coordinate across member rows, drops ``floor(trim_frac*k)``
    values from each end (``k`` = member count, trim clamped so at least
    one value survives), and means the rest, summed in row order from
    +0.0 (the trimmed rows' zeros add nothing to a sum that starts at +0.0)."""
    if not 0.0 <= float(trim_frac) < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
    xs, k = _sorted_members(x, mask)
    t = int(np.floor(np.float32(trim_frac) * np.float32(k)))
    t = min(t, (k - 1) // 2)  # keep >= 1 surviving value
    acc = torch.zeros(xs.shape[1:], dtype=torch.float32, device=xs.device)
    for i in range(t, k - t):
        acc = acc + xs[i]
    return acc / float(max(k - 2 * t, 1))


def masked_median(x: torch.Tensor, mask) -> torch.Tensor:
    """Coordinate-wise median of ``x[(P, ...)]`` over ``mask[(P,)]`` — even
    member counts average the two middle values (numpy semantics)."""
    xs, k = _sorted_members(x, mask)
    return 0.5 * (xs[(k - 1) // 2] + xs[k // 2])


# ---------------------------------------------------------------------------
# Krum / multi-Krum (vector-wise, full bank)
# ---------------------------------------------------------------------------


def flatten_bank(bank: Bank) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Dict[str, torch.Tensor]]]:
    """Bank -> ``(P, D)`` f32 matrix + an unflatten closure for one row.

    The row is the reference's: leaves in JAX leaf order, each in the
    reference's layout (HWIO convolutions, ``(din, dout)`` linear weights),
    raveled and concatenated."""
    names = jax_order(bank)
    P = bank[names[0]].shape[0]
    jleaves = [to_jax_layout(bank[n], lead=1) for n in names]
    flat = torch.cat([j.reshape(P, -1).to(torch.float32) for j in jleaves], dim=1)
    shapes = [tuple(j.shape[1:]) for j in jleaves]
    offsets = np.cumsum([0] + [int(np.prod(s)) if s else 1 for s in shapes])

    def unflatten(row: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            n: to_torch_layout(row[offsets[i]: offsets[i + 1]].reshape(shapes[i]))
            for i, n in enumerate(names)
        }

    return flat, unflatten


def gram(flat: torch.Tensor) -> torch.Tensor:
    """``flat @ flat.T`` for a ``(P, D)`` f32 bank as P (P + 1) / 2 f32 dot
    products: a matrix product would take TF32 on the card when the
    caller's global flag allows it."""
    P = flat.shape[0]
    g = torch.empty((P, P), dtype=torch.float32, device=flat.device)
    for i in range(P):
        for j in range(i, P):
            g[i, j] = g[j, i] = torch.dot(flat[i], flat[j])
    return g


def krum_scores(flat: torch.Tensor, f: Optional[int] = None) -> torch.Tensor:
    """Krum distance scores over a ``(P, D)`` bank: ``score_i`` = sum of
    squared distances to ``i``'s ``P - f - 2`` nearest other rows
    (Blanchard et al., 2017). Lower = more central = more trustworthy.

    ``f`` is the assumed Byzantine count; defaults to the maximum the
    estimator tolerates, ``floor((P - 3) / 2)``. Distances come from the
    Gram matrix, clamped at zero against float cancellation."""
    P = int(flat.shape[0])
    if P < 3:
        raise ValueError(f"krum needs at least 3 peers, got {P}")
    if f is None:
        f = (P - 3) // 2
    f = int(f)
    if not 0 <= f <= P - 3:
        raise ValueError(f"krum assumed attacker count f={f} outside [0, {P - 3}]")
    flat = flat.to(torch.float32)
    sqn = (flat * flat).sum(dim=1)
    d2 = torch.clamp(sqn[:, None] + sqn[None, :] - 2.0 * gram(flat), min=0.0)
    d2 = d2 + torch.diag(torch.full((P,), float("inf"), device=flat.device))  # exclude self
    near = P - f - 2  # >= 1 by the f bound above
    return torch.sort(d2, dim=1).values[:, :near].sum(dim=1)


def krum_select(flat: torch.Tensor, *, m: int = 1, f: Optional[int] = None):
    """Multi-Krum: average the ``m`` lowest-scored rows of ``(P, D)``.

    Returns ``(aggregate (D,), selected row indices (m,))``; ``m=1`` is
    classic Krum (the single most central gradient)."""
    P = int(flat.shape[0])
    m = int(m)
    if not 1 <= m <= P:
        raise ValueError(f"krum selection count m={m} outside [1, {P}]")
    scores = krum_scores(flat, f)
    sel = torch.argsort(scores, stable=True)[:m]
    agg = torch.zeros(flat.shape[1:], dtype=torch.float32, device=flat.device)
    for i in sel.tolist():  # the selected rows summed in order of score from +0.0
        agg = agg + flat[i].to(torch.float32)
    # the reference's compiled mean multiplies by the f32 reciprocal of m
    return agg * float(np.float32(1.0) / np.float32(m)), sel


# ---------------------------------------------------------------------------
# Adversary model
# ---------------------------------------------------------------------------

ATTACK_KINDS = ("sign_flip", "scaled_noise", "stale_replay")


@dataclass(frozen=True)
class AdversarySpec:
    """A seeded Byzantine attacker set + the attack its members mount.

    ``fraction`` of the peers (or an explicit ``num``) are attackers, chosen
    uniformly without replacement from ``seed`` with numpy's generator, as
    the reference chooses them — so a fixed seed fixes which peers are
    malicious across protocols and graphs. Attack kinds:

    * ``sign_flip`` — publish ``-scale x`` the honest gradient.
    * ``scaled_noise`` — publish ``scale x N(0, 1)`` noise of the honest
      gradient's shape.
    * ``stale_replay`` — re-publish the attacker's previous epoch's wire
      payload verbatim (epoch 0 publishes honestly). Host path only.
    """

    fraction: float = 0.0
    num: Optional[int] = None  # explicit attacker count, overrides fraction
    attack: str = "sign_flip"
    scale: float = 10.0  # sign-flip / noise magnitude multiplier
    seed: int = 0

    def __post_init__(self):
        if self.attack not in ATTACK_KINDS:
            raise ValueError(
                f"unknown attack {self.attack!r}; kinds: {', '.join(ATTACK_KINDS)}"
            )
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {self.fraction}")
        if self.num is not None and self.num < 0:
            raise ValueError(f"num must be >= 0, got {self.num}")

    def num_attackers(self, num_peers: int) -> int:
        if self.num is not None:
            return min(int(self.num), int(num_peers))
        return int(round(self.fraction * num_peers))

    def attackers(self, num_peers: int) -> Tuple[int, ...]:
        """The seeded attacker ranks, ascending."""
        n = self.num_attackers(num_peers)
        if n == 0:
            return ()
        rng = np.random.default_rng(self.seed)
        return tuple(sorted(int(r) for r in rng.choice(num_peers, size=n, replace=False)))

    def is_attacker(self, rank: int, num_peers: int) -> bool:
        return rank in self.attackers(num_peers)

    def mask(self, num_peers: int) -> np.ndarray:
        """(P,) bool — True at attacker ranks."""
        m = np.zeros(num_peers, dtype=bool)
        m[list(self.attackers(num_peers))] = True
        return m

    @property
    def active(self) -> bool:
        return self.num is not None and self.num > 0 or self.fraction > 0.0

    def describe(self) -> str:
        return (
            f"adversary({self.attack}, "
            f"{'num=' + str(self.num) if self.num is not None else f'frac={self.fraction:g}'}"
            f", scale={self.scale:g}, seed={self.seed})"
        )


def draw_normals(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normals of ``shape`` in f32, drawn on the generator's device.

    The one place the adversary model draws random numbers: ``scaled_noise``
    calls it once per leaf, in JAX leaf order, with the leaf's shape in the
    reference's layout (and any leading dimensions in front)."""
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device)


def poison_gradients(grads: Bank, spec: AdversarySpec, generator: Optional[torch.Generator] = None,
                     *, lead: int = 0) -> Dict[str, torch.Tensor]:
    """An attacker's poisoned gradient under ``sign_flip``/``scaled_noise``,
    f32. ``lead`` leading dimensions (the device step's attacker rows) are
    kept in front; ``scaled_noise`` draws from ``generator``.
    ``stale_replay`` is payload-level and handled by the cluster's publish
    cache (this function refuses it)."""
    if spec.attack == "sign_flip":
        return {k: -spec.scale * g.to(torch.float32) for k, g in grads.items()}
    if spec.attack == "scaled_noise":
        if generator is None:
            raise ValueError("the scaled_noise attack requires a torch.Generator")
        out = {}
        for name in jax_order(grads):
            jshape = to_jax_layout(grads[name], lead=lead).shape
            out[name] = to_torch_layout(spec.scale * draw_normals(jshape, generator), lead=lead)
        return {k: out[k] for k in grads}
    raise ValueError(
        f"attack {spec.attack!r} is payload-level (host mailbox path only) "
        "and cannot be expressed as a gradient transform"
    )


def tree_all_finite(tree: Bank) -> bool:
    """Host-side non-finite check: True iff every leaf is finite everywhere."""
    return all(bool(torch.isfinite(leaf.to(torch.float32)).all()) for leaf in tree.values())

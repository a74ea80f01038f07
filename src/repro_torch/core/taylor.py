"""F-Permutation table-wise importance scores (SHARK Eq. 4).

Port of ``repro/core/taylor.py``.  The Permutation test scores field i
by the expected loss increase when its value is resampled from the
dataset marginal; SHARK approximates it with the first-order Taylor
expansion around the sample's own embedding e_i(x):

    error(i, x) = dLoss/de_i(x) . (E[e_i] - e_i(x))             (Eq. 4)
    score(i)    = mean_x error(i, x)                            (Eq. 2-3)

One pass for the field means E[e_i] (lookup only), one forward and
backward for the gradients; the model is not modified.

Interface contract (every recsys model in ``repro_torch.models``):

    embed_fn(params, batch)            -> emb (B, F, D)
    loss_fn(params, emb, batch)        -> per-sample loss (B,)

The second-order variant adds 1/2 E[(v'-v)^T H (v'-v)], estimated as the
mean-shift curvature term plus a Hutchinson trace of H against the field
covariance.  The reference's forward-over-reverse ``jax.jvp(grad)`` is a
Hessian-vector product by double backward here (``torch.autograd.grad``
with ``create_graph=True``; H is symmetric), and its ``jax.random``
Rademacher probes come from a ``torch.Generator`` (``rademacher=`` takes
any other source, e.g. the reference's draws in a test).
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch

EmbedFn = Callable[..., torch.Tensor]
LossFn = Callable[..., torch.Tensor]
Rademacher = Callable[[int, tuple], torch.Tensor]


class FieldMoments(NamedTuple):
    mean: torch.Tensor      # (F, D)  E[e_i]
    sq_mean: torch.Tensor   # (F, D)  E[e_i^2]  (second-order variant only)
    count: torch.Tensor     # ()      samples seen

    def var(self) -> torch.Tensor:
        return torch.clamp_min(self.sq_mean - self.mean ** 2, 0.0)


def init_moments(num_fields: int, dim: int,
                 device: torch.device | str = "cpu") -> FieldMoments:
    z = torch.zeros((num_fields, dim), dtype=torch.float32, device=device)
    return FieldMoments(mean=z, sq_mean=z.clone(),
                        count=torch.zeros((), dtype=torch.float32,
                                          device=device))


def update_moments(m: FieldMoments, emb: torch.Tensor) -> FieldMoments:
    """Streaming mean / mean-square update with one (B, F, D) batch."""
    b = emb.shape[0]
    new_count = m.count + b
    w_old = m.count / new_count
    w_new = b / new_count
    return FieldMoments(
        mean=w_old * m.mean + w_new * emb.mean(dim=0),
        sq_mean=w_old * m.sq_mean + w_new * (emb ** 2).mean(dim=0),
        count=new_count)


@torch.no_grad()
def field_moments(embed_fn: EmbedFn, params, batches: Iterable
                  ) -> FieldMoments:
    """Pass 1 of F-Permutation: frequency-weighted field means."""
    m = None
    for batch in batches:
        emb = embed_fn(params, batch)
        if m is None:
            m = init_moments(emb.shape[1], emb.shape[2], emb.device)
        m = update_moments(m, emb)
    if m is None:
        raise ValueError("empty eval stream")
    return m


def _value_and_grad(params, batch, embed_fn: EmbedFn, loss_fn: LossFn,
                    create_graph: bool = False):
    """(emb leaf, summed loss, d loss / d emb)."""
    with torch.no_grad():
        emb0 = embed_fn(params, batch)
    emb = emb0.detach().requires_grad_()
    loss = loss_fn(params, emb, batch).sum()
    (grad,) = torch.autograd.grad(loss, emb, create_graph=create_graph)
    return emb, loss, grad


def _batch_scores_first(params, batch, mean: torch.Tensor,
                        embed_fn: EmbedFn, loss_fn: LossFn
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch Eq. 4 scores (summed, not averaged) + summed loss."""
    with torch.enable_grad():
        emb, loss, grad = _value_and_grad(params, batch, embed_fn, loss_fn)
    delta = mean[None, :, :] - emb.detach()
    return torch.einsum("bfd,bfd->f", grad, delta), loss.detach()


def _batch_scores_second(params, batch, moments: FieldMoments,
                         embed_fn: EmbedFn, loss_fn: LossFn,
                         rademacher: Rademacher, probes: int = 2
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Second-order variant: adds 1/2 [d^T H d + tr(H diag(var))] per
    field."""
    with torch.enable_grad():
        emb, loss, grad = _value_and_grad(params, batch, embed_fn, loss_fn,
                                          create_graph=True)
        delta = moments.mean[None, :, :] - emb.detach()

        def hvp(v: torch.Tensor) -> torch.Tensor:
            (hv,) = torch.autograd.grad(grad, emb, grad_outputs=v,
                                        retain_graph=True)
            return hv

        # mean-shift curvature: d^T H d via one hvp along d
        quad_mean = torch.einsum("bfd,bfd->f", delta, hvp(delta))
        # trace term: E_z[(z*s)^T H (z*s)], Rademacher z, s = sqrt(var)
        std = torch.sqrt(moments.var())[None, :, :]
        trace = torch.zeros(emb.shape[1], dtype=torch.float32,
                            device=emb.device)
        for p in range(probes):
            v = rademacher(p, tuple(emb.shape)).to(emb.device) * std
            trace = trace + torch.einsum("bfd,bfd->f", v, hvp(v))
        trace = trace / probes
    first = torch.einsum("bfd,bfd->f", grad.detach(), delta)
    return first + 0.5 * (quad_mean + trace), loss.detach()


def generator_rademacher(generator: torch.Generator) -> Rademacher:
    """Rademacher probes (+-1 fp32) drawn from ``generator``."""
    def draw(p: int, shape: tuple) -> torch.Tensor:
        bits = torch.randint(0, 2, shape, generator=generator,
                             device=generator.device)
        return bits.to(torch.float32) * 2.0 - 1.0
    return draw


def fperm_scores(embed_fn: EmbedFn, loss_fn: LossFn, params,
                 batches: Iterable, moments: FieldMoments | None = None,
                 order: int = 1, generator: torch.Generator | None = None,
                 rademacher: Rademacher | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, FieldMoments]:
    """Full F-Permutation scoring pass.

    Returns (scores (F,), mean_loss (), moments).  If ``moments`` is None
    a first pass over ``batches`` computes it.  ``order=2`` draws its
    probes from ``rademacher(p, shape)`` if given, else from
    ``generator`` (a CPU generator seeded 0 by default).
    """
    batches = list(batches)
    if moments is None:
        moments = field_moments(embed_fn, params, batches)
    if order == 1:
        def step(b):
            return _batch_scores_first(params, b, moments.mean, embed_fn,
                                       loss_fn)
    else:
        if rademacher is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            rademacher = generator_rademacher(generator)

        def step(b):
            return _batch_scores_second(params, b, moments, embed_fn,
                                        loss_fn, rademacher)
    scores = None
    loss_sum = 0.0
    count = 0
    for batch in batches:
        s, loss = step(batch)
        scores = s if scores is None else scores + s
        loss_sum = loss_sum + loss
        count += _batch_size(batch)
    return scores / count, loss_sum / count, moments


def _batch_size(batch) -> int:
    if isinstance(batch, dict):
        return next(iter(batch.values())).shape[0]
    return batch.shape[0]

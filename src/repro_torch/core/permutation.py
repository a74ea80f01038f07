"""Original Permutation feature importance (Fisher et al. 2019), Eq. 1-3.

Port of ``repro/core/permutation.py``: the baseline SHARK's
F-Permutation approximates.  For field i, shuffle its embeddings across
the batch T times (the batch's empirical marginal stands in for "a
candidate from another sample") and take the mean loss increase:

    error(i) ~= 1/T sum_t [ loss(shuffle_t(e_i)) ] - loss(e)

O(|DATA| * N * T) forward passes, the cost Table 2 shows.  Shuffling the
embeddings equals shuffling the raw values (a field's lookup is a
bijection) and saves the lookups.

The permutations come from a *draw source*: a ``torch.Generator``
(``randperm`` on its device; a CPU generator seeded 0 by default), or a
callable ``(batch_index, field, shuffle) -> LongTensor (B,)``, through
which a test feeds the reference's ``fold_in`` permutations.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

Perm = Callable[[int, int, int], torch.Tensor]


def _permuted_loss(params, batch, perm: torch.Tensor, field: int,
                   embed_fn, loss_fn) -> torch.Tensor:
    emb = embed_fn(params, batch)
    shuffled = emb.clone()
    shuffled[:, field, :] = emb[perm.to(emb.device), field, :]
    return loss_fn(params, shuffled, batch).mean()


@torch.no_grad()
def permutation_scores(embed_fn: Callable, loss_fn: Callable, params,
                       batches: Iterable, num_fields: int,
                       num_shuffles: int = 1,
                       generator: torch.Generator | None = None,
                       perms: Perm | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1-3 by batch-level shuffling.  Returns (scores (F,), base_loss).

    ``perms(bi, field, t)`` gives the t-th permutation of field ``field``
    on batch ``bi`` when given; else they are drawn from ``generator``.
    """
    if perms is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    base = 0.0
    scores = None
    n_batches = 0
    for bi, batch in enumerate(batches):
        n_batches += 1
        base_l = loss_fn(params, embed_fn(params, batch), batch).mean()
        base = base + base_l
        bsz = next(iter(batch.values())).shape[0]
        per_field = []
        for f in range(num_fields):
            acc = 0.0
            for t in range(num_shuffles):
                perm = perms(bi, f, t) if perms is not None else \
                    torch.randperm(bsz, generator=generator,
                                   device=generator.device)
                acc = acc + _permuted_loss(params, batch, perm, f,
                                           embed_fn, loss_fn)
            per_field.append(acc / num_shuffles - base_l)
        s = torch.stack(per_field)
        scores = s if scores is None else scores + s
    return scores / n_batches, base / n_batches

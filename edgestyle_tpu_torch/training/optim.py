"""optax's pieces that the trainer chains around its optimizer: global-norm
clipping, AdamW and ``apply_updates``, over the port's dict trees.

Counterparts of ``optax.clip_by_global_norm``, ``optax.adamw`` and
``optax.apply_updates`` with their formulas: clipping scales by
``max_norm / ||g||`` only when ``||g|| >= max_norm`` (no ``+ 1e-6`` as in
``torch.nn.utils.clip_grad_norm_``), and AdamW adds the decayed weights
after the bias-corrected Adam direction and then scales by ``-lr``.
"""

from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from edgestyle_tpu_torch.core.params import flatten, unflatten

Schedule = Union[float, Callable[[int], float]]


def global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a 0-d tensor."""
    return torch.sqrt(torch.stack([v.float().square().sum() for v in flatten(tree).values()]).sum())


def clip_by_global_norm(grads: Dict, max_norm: float) -> Dict:
    """optax.clip_by_global_norm: g unchanged when ||g|| < max_norm, else
    (g / ||g||) * max_norm. No host sync: the choice is a device select."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return unflatten({k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                      for k, g in flatten(grads).items()})


def apply_updates(params: Dict, updates: Dict) -> Dict:
    """params + updates, leaf by leaf, as a new tree."""
    u = flatten(updates)
    return unflatten({k: (v + u[k]).to(v.dtype) for k, v in flatten(params).items()})


class AdamW:
    """optax.adamw (eps_root 0, no mask, no Nesterov): ``init(params) ->
    state``, ``update(grads, state, params) -> (updates, state)``. The step
    count is a host int."""

    def __init__(self, learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.lr = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict) -> Dict:
        zeros = lambda: unflatten({k: torch.zeros_like(v)  # noqa: E731
                                   for k, v in flatten(params).items()})
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def update(self, grads: Dict, state: Dict, params: Dict):
        b1, b2 = self.b1, self.b2
        g, p = flatten(grads), flatten(params)
        mu0, nu0 = flatten(state["mu"]), flatten(state["nu"])
        count = state["count"] + 1
        lr = self.lr(state["count"]) if callable(self.lr) else float(self.lr)
        mu = {k: (1 - b1) * g[k] + b1 * mu0[k] for k in p}
        nu = {k: (1 - b2) * g[k].square() + b2 * nu0[k] for k in p}
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = {}
        for k in p:
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            updates[k] = -lr * (u + self.weight_decay * p[k])
        return unflatten(updates), {"count": count, "mu": unflatten(mu), "nu": unflatten(nu)}


class ClippedOptimizer:
    """optax.chain(clip_by_global_norm(max_norm), inner): the clipping has no
    state, so the state is the inner optimizer's."""

    def __init__(self, inner, max_norm: float):
        self.inner = inner
        self.max_norm = max_norm

    def init(self, params: Dict) -> Dict:
        return self.inner.init(params)

    def update(self, grads: Dict, state: Dict, params: Dict):
        return self.inner.update(clip_by_global_norm(grads, self.max_norm), state, params)

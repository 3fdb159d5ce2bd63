"""The Prodigy optimizer over the port's dict trees.

Counterpart of edgestyle_tpu/training/prodigy.py (prodigyopt.Prodigy as
the reference trains with it: lr 1.0, betas (0.9, 0.999), beta3 None ->
sqrt(beta2), decoupled weight decay, bias correction and safeguard warmup
on), line for line:

  m <- b1 m + d (1 - b1) g
  v <- b2 v + d^2 (1 - b2) g^2
  num <- b3 num + (d / D0) dlr <g, x0 - x>
  s <- b3 s + (d / D0) (d if safeguard else dlr) g
  d_hat = num / sum|s| ;  d_max <- max(d_max, d_hat) ;  d <- max(d, d_max)
  x <- x - dlr m / (sqrt(v) + d eps) - dlr wd x      (dlr = d lr bias_correction)

The eps term uses the new d while dlr keeps the old one, and d never falls.
d starts at D0, with prodigyopt's default d_coef 1 and unbounded growth,
which are what the trainer uses.
``d``, ``d_max`` and ``d_numerator`` are 0-d fp32 device tensors and the step
a host int, so an update never waits on the device. The state is a plain
dict: {step, d, d_max, d_numerator, exp_avg, exp_avg_sq, s, p0}.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import torch

from edgestyle_tpu_torch.core.params import flatten, unflatten

Schedule = Union[float, Callable[[int], float]]
D0 = 1e-6


class Prodigy:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, functional like the optax transformation it ports:
    the caller adds the updates (:func:`apply_updates`)."""

    def __init__(self, learning_rate: Schedule = 1.0, betas=(0.9, 0.999),
                 beta3: Optional[float] = None, eps: float = 1e-8, weight_decay: float = 0.0,
                 decouple: bool = True, use_bias_correction: bool = True,
                 safeguard_warmup: bool = True):
        self.lr = learning_rate
        self.beta1, self.beta2 = betas
        self.beta3 = beta3 if beta3 is not None else self.beta2 ** 0.5
        self.eps = eps
        self.weight_decay = weight_decay
        self.decouple = decouple
        self.use_bias_correction = use_bias_correction
        self.safeguard_warmup = safeguard_warmup

    def init(self, params: Dict) -> Dict:
        leaves = flatten(params)
        dev = next(iter(leaves.values())).device
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        zeros = lambda: unflatten({k: torch.zeros_like(v) for k, v in leaves.items()})  # noqa: E731
        return {"step": 0, "d": scalar(D0), "d_max": scalar(D0),
                "d_numerator": scalar(0.0), "exp_avg": zeros(), "exp_avg_sq": zeros(),
                "s": zeros(), "p0": unflatten({k: v.clone() for k, v in leaves.items()})}

    def update(self, grads: Dict, state: Dict, params: Dict):
        b1, b2, b3 = self.beta1, self.beta2, self.beta3
        k = state["step"]
        d = state["d"]
        lr = self.lr(k) if callable(self.lr) else float(self.lr)
        bc = (math.sqrt(1.0 - b2 ** (k + 1)) / (1.0 - b1 ** (k + 1))
              if self.use_bias_correction else 1.0)
        dlr = d * (lr * bc)

        g, p = flatten(grads), flatten(params)
        m0, v0 = flatten(state["exp_avg"]), flatten(state["exp_avg_sq"])
        s0, x0 = flatten(state["s"]), flatten(state["p0"])
        keys = list(p)
        m = {n: b1 * m0[n] + d * (1 - b1) * g[n] for n in keys}
        v = {n: b2 * v0[n] + d * d * (1 - b2) * g[n] * g[n] for n in keys}
        dot = torch.stack([(g[n].float() * (x0[n] - p[n]).float()).sum() for n in keys]).sum()
        d_numerator = b3 * state["d_numerator"] + (d / D0) * dlr * dot
        s_coef = (d / D0) * (d if self.safeguard_warmup else dlr)
        s = {n: b3 * s0[n] + s_coef * g[n] for n in keys}
        d_denom = torch.stack([s[n].float().abs().sum() for n in keys]).sum()
        d_hat = torch.where(d_denom > 0.0,
                            d_numerator / torch.clamp(d_denom, min=1e-30), d)
        d_max = torch.maximum(state["d_max"], d_hat)
        new_d = torch.maximum(d_max, d)

        updates = {}
        for n in keys:
            step = dlr * m[n] / (torch.sqrt(v[n]) + new_d * self.eps)
            if self.weight_decay > 0.0 and self.decouple:
                step = step + dlr * self.weight_decay * p[n]
            updates[n] = -step
        new_state = {"step": k + 1, "d": new_d, "d_max": d_max, "d_numerator": d_numerator,
                     "exp_avg": unflatten(m), "exp_avg_sq": unflatten(v), "s": unflatten(s),
                     "p0": state["p0"]}
        return unflatten(updates), new_state


def get_d(opt_state: Dict) -> torch.Tensor:
    """Prodigy's d (the logged 'train_lr')."""
    return opt_state["d"]


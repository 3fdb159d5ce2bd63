"""UniPC multistep scheduler (predict_x0, bh2, lower_order_final).

Counterpart of edgestyle_tpu/schedulers/unipc.py. The plan is host numpy:
timesteps, the half-log-SNR and alpha/sigma tables, and the per-step
effective orders (``pred_order``, ``corr_order``, ``use_corrector``), which
depend only on the step index and the step count. Each step picks its
branches in Python from those tables and computes every coefficient as a
host float32 scalar, so the loop enqueues tensor ops only and makes no
host sync per step. The last step is order 1 (the sigma -> 0 limit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.loop import SampleLoop

_F = np.float32


@dataclasses.dataclass(frozen=True)
class UniPCPlan:
    """Per-step tables, each shape (N,)."""

    timesteps: np.ndarray
    lambda_s0: np.ndarray
    lambda_t: np.ndarray
    alpha_t: np.ndarray
    sigma_t: np.ndarray
    alpha_s0: np.ndarray
    sigma_s0: np.ndarray
    pred_order: np.ndarray
    corr_order: np.ndarray
    use_corrector: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def _solve_monomial(r, b):
    """Solve R x = b with R[i, j] = r[j]**i, n <= 3, by Cramer's rule."""
    n = len(r)
    if n == 1:
        return [b[0]]
    if n == 2:
        det = r[1] - r[0]
        return [(r[1] * b[0] - b[1]) / det, (b[1] - r[0] * b[0]) / det]
    if n == 3:
        m = [[_F(1.0), _F(1.0), _F(1.0)], list(r), [r[0] * r[0], r[1] * r[1], r[2] * r[2]]]

        def det3(a):
            return (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
                    - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
                    + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))

        d = det3(m)
        return [det3([[b[i] if k == j else m[i][k] for k in range(3)] for i in range(3)]) / d
                for j in range(3)]
    raise ValueError(f"unsupported system size {n}")


def _b_coeffs(hh, B_h, K: int):
    h_phi_1 = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - _F(1.0)
    bs = []
    fact = _F(1.0)
    for i in range(1, K + 1):
        bs.append(h_phi_k * fact / B_h)
        fact = fact * _F(i + 1)
        h_phi_k = h_phi_k / hh - _F(1.0) / fact
    return bs


class UniPCScheduler(SampleLoop):
    def __init__(self, sched: NoiseSchedule, solver_order: int = 2,
                 lower_order_final: bool = True):
        if solver_order not in (1, 2, 3):
            raise ValueError("solver_order must be 1, 2 or 3")
        self.sched = sched
        self.order = solver_order
        self.lower_order_final = lower_order_final

    def plan(self, num_inference_steps: int) -> UniPCPlan:
        T = self.sched.num_train_timesteps
        ac = np.asarray(self.sched.alphas_cumprod, dtype=np.float64)
        ts = (np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1]
              .astype(np.int64))
        alpha = np.sqrt(ac[ts])
        sigma = np.sqrt(1.0 - ac[ts])
        lam = np.log(alpha) - np.log(sigma)
        alpha_t = np.concatenate([alpha[1:], [1.0]])
        sigma_t = np.concatenate([sigma[1:], [0.0]])
        with np.errstate(divide="ignore"):
            lam_t = np.log(alpha_t) - np.log(sigma_t)
        n = num_inference_steps
        pred_order = np.zeros(n, np.int32)
        corr_order = np.zeros(n, np.int32)
        lon, prev = 0, 1
        for i in range(n):
            o = min(self.order, n - i) if self.lower_order_final else self.order
            o = min(o, lon + 1)
            pred_order[i] = o
            corr_order[i] = prev
            prev = o
            if lon < self.order:
                lon += 1
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        return UniPCPlan(
            timesteps=ts.astype(np.int32), lambda_s0=f32(lam), lambda_t=f32(lam_t),
            alpha_t=f32(alpha_t), sigma_t=f32(sigma_t), alpha_s0=f32(alpha),
            sigma_s0=f32(sigma), pred_order=pred_order, corr_order=corr_order,
            use_corrector=np.arange(n) > 0,
        )

    def init_state(self, sample: torch.Tensor) -> Dict:
        zeros = torch.zeros_like(sample, dtype=torch.float32)
        return {"hist_m": [zeros] * self.order,        # [0] = newest x0
                "hist_lambda": [_F(0.0)] * self.order,
                "last_sample": zeros}

    def to_x0(self, model_output, sample, t: int):
        ac = self.sched.alphas_cumprod[t]
        a, s = np.sqrt(ac), np.sqrt(_F(1.0) - ac)
        if self.sched.prediction_type == "epsilon":
            return (sample - float(s) * model_output) / float(a)
        return float(a) * sample - float(s) * model_output

    def _bh_update(self, order: int, m0, x, older_m: List[torch.Tensor], older_lambda,
                   lam_s0, lam_t, alpha_t, sigma_t, sigma_s0, D1_t=None):
        with np.errstate(all="ignore"):  # the final step's target has sigma 0
            h = lam_t - lam_s0
            hh = -h
            B_h = np.expm1(hh)
            b = _b_coeffs(hh, B_h, self.order)
            num_hist = order - 1
            rks = [(older_lambda[j] - lam_s0) / h for j in range(num_hist)]
            c_x = sigma_t / sigma_s0
            c_m = alpha_t * np.expm1(hh)
            c_out = alpha_t * B_h
        d1s = [(older_m[j] - m0) / float(rks[j]) for j in range(num_hist)]
        x_t_ = float(c_x) * x - float(c_m) * m0
        if D1_t is not None:
            rhos = [_F(0.5)] if order == 1 else _solve_monomial(rks + [_F(1.0)], b[:order])
            corr = torch.zeros_like(m0)
            for j in range(num_hist):
                corr = corr + float(rhos[j]) * d1s[j]
            corr = corr + float(rhos[order - 1]) * D1_t
            return x_t_ - float(c_out) * corr
        if num_hist == 0:
            return x_t_
        rhos = [_F(0.5)] if num_hist == 1 else _solve_monomial(rks, b[:num_hist])
        pred = torch.zeros_like(m0)
        for j in range(num_hist):
            pred = pred + float(rhos[j]) * d1s[j]
        return x_t_ - float(c_out) * pred

    def step(self, plan: UniPCPlan, i: int, model_output, sample,
             state: Dict) -> Tuple[torch.Tensor, Dict]:
        """Corrector for the i-1 -> i transition (i > 0), then the predictor
        i -> i+1; ``model_output`` is the raw model output at step i."""
        t = int(plan.timesteps[i])
        sample_f32 = sample.float()
        x0 = self.to_x0(model_output.float(), sample_f32, t)
        hist_m, hist_lambda = state["hist_m"], state["hist_lambda"]
        if plan.use_corrector[i]:
            corrected = self._bh_update(
                int(plan.corr_order[i]), hist_m[0], state["last_sample"], hist_m[1:],
                hist_lambda[1:], hist_lambda[0], plan.lambda_s0[i], plan.alpha_s0[i],
                plan.sigma_s0[i], plan.sigma_s0[i - 1], D1_t=x0 - hist_m[0])
        else:
            corrected = sample_f32
        new_m = [x0] + hist_m[:-1]
        new_lambda = [plan.lambda_s0[i]] + hist_lambda[:-1]
        nxt = self._bh_update(
            int(plan.pred_order[i]), x0, corrected, new_m[1:], new_lambda[1:],
            plan.lambda_s0[i], plan.lambda_t[i], plan.alpha_t[i], plan.sigma_t[i],
            plan.sigma_s0[i])
        return nxt.to(sample.dtype), {"hist_m": new_m, "hist_lambda": new_lambda,
                                      "last_sample": corrected}

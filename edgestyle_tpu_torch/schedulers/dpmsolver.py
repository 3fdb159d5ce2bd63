"""DPM-Solver++ 2M multistep scheduler.

Counterpart of edgestyle_tpu/schedulers/dpmsolver.py in the configuration
the pipeline runs (the JAX class's defaults), with diffusers'
DPMSolverMultistepScheduler semantics: algorithm_type="dpmsolver++"
(predict x0), solver_order=2, solver_type="midpoint",
lower_order_final=True, timestep_spacing="linspace",
final_sigmas_type="zero" (the last step is first order and returns x0).
One model call per step, no corrector.

The plan is host numpy: timesteps, the half-log-SNR and alpha/sigma tables
and the per-step effective order. The state is the ring of x0 predictions
(``[0]`` the newest); each step picks its order's update in Python and
computes its coefficients as host float32 scalars, so the loop makes no
host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.loop import SampleLoop

_F = np.float32


@dataclasses.dataclass(frozen=True)
class DPMSolverPlan:
    """Per-step tables, each shape (N,)."""

    timesteps: np.ndarray
    lambda_s0: np.ndarray  # half-log-SNR at each step's source
    lambda_s1: np.ndarray  # ... at the previous step's source (unread at i=0)
    lambda_t: np.ndarray   # ... at each step's target
    alpha_t: np.ndarray
    sigma_t: np.ndarray
    alpha_s0: np.ndarray
    sigma_s0: np.ndarray
    order: np.ndarray      # the effective solver order of each step

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


class DPMSolverScheduler(SampleLoop):
    order = 2

    def __init__(self, sched: NoiseSchedule):
        self.sched = sched

    def plan(self, num_inference_steps: int) -> DPMSolverPlan:
        T = self.sched.num_train_timesteps
        ac = np.asarray(self.sched.alphas_cumprod, dtype=np.float64)
        ts = (np.linspace(0, T - 1, num_inference_steps + 1).round()[::-1][:-1]
              .astype(np.int64))
        alpha = np.sqrt(ac[ts])
        sigma = np.sqrt(1.0 - ac[ts])
        lam = np.log(alpha) - np.log(sigma)
        alpha_t = np.concatenate([alpha[1:], [1.0]])  # the final sigma is zero
        sigma_t = np.concatenate([sigma[1:], [0.0]])
        with np.errstate(divide="ignore"):
            lam_t = np.log(alpha_t) - np.log(sigma_t)
        lam_s1 = np.concatenate([[lam[0]], lam[:-1]])
        # diffusers' step() gate at order 2: the first step is order 1 (no
        # history yet), and so is the last (zero final sigma)
        order = np.full(num_inference_steps, 2, np.int32)
        order[0] = order[-1] = 1
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        return DPMSolverPlan(
            timesteps=ts.astype(np.int32), lambda_s0=f32(lam), lambda_s1=f32(lam_s1),
            lambda_t=f32(lam_t), alpha_t=f32(alpha_t), sigma_t=f32(sigma_t),
            alpha_s0=f32(alpha), sigma_s0=f32(sigma), order=order)

    def init_state(self, sample: torch.Tensor) -> Dict:
        return {"hist_m": [torch.zeros_like(sample, dtype=torch.float32)] * self.order}

    def to_x0(self, model_output, sample, t: int):
        ac = self.sched.alphas_cumprod[t]
        a, s = np.sqrt(ac), np.sqrt(_F(1.0) - ac)
        if self.sched.prediction_type == "epsilon":
            return (sample - float(s) * model_output) / float(a)
        return float(a) * sample - float(s) * model_output

    def _update(self, order: int, hist_m, sample, plan: DPMSolverPlan, i: int):
        """One dpmsolver++ update at ``order`` (midpoint at 2), its
        coefficients host float32 as the JAX package computes them on the
        device."""
        with np.errstate(all="ignore"):  # h = inf on the zero-sigma last step
            lam_s0, lam_t = plan.lambda_s0[i], plan.lambda_t[i]
            alpha_t = plan.alpha_t[i]
            h = lam_t - lam_s0
            ehm1 = np.expm1(-h)  # exactly -1 on the last step
            x_t = (float(plan.sigma_t[i] / plan.sigma_s0[i]) * sample
                   - float(alpha_t * ehm1) * hist_m[0])
            if order == 1:
                return x_t
            r0 = (lam_s0 - plan.lambda_s1[i]) / h
            d1_0 = (hist_m[0] - hist_m[1]) / float(r0)
            return x_t - float(_F(0.5) * alpha_t * ehm1) * d1_0

    def step(self, plan: DPMSolverPlan, i: int, model_output, sample,
             state: Dict) -> Tuple[torch.Tensor, Dict]:
        """The update i -> i+1; ``model_output`` is the raw model output at
        (sample, plan.timesteps[i])."""
        t = int(plan.timesteps[i])
        sample_f32 = sample.float()
        x0 = self.to_x0(model_output.float(), sample_f32, t)
        hist_m = [x0] + state["hist_m"][:-1]
        nxt = self._update(int(plan.order[i]), hist_m, sample_f32, plan, i)
        return nxt.to(sample.dtype), {"hist_m": hist_m}

"""DDIM sampler step (eta = 0, deterministic).

Counterpart of edgestyle_tpu/schedulers/ddim.py: the baseline sampler and
a cross-check for UniPC, with diffusers' "leading" timestep spacing of the
SD1.5 DDIM configs (or "linspace"). The timesteps are host int64 and the
step's coefficients host float32 scalars, as the other samplers' plans
are, so a step only enqueues device work.
"""

from __future__ import annotations

import numpy as np
import torch

from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule


class DDIMScheduler:
    def __init__(self, sched: NoiseSchedule):
        self.sched = sched

    def timesteps(self, num_inference_steps: int, spacing: str = "leading") -> np.ndarray:
        """(num_inference_steps,) descending host int64 timesteps."""
        T = self.sched.num_train_timesteps
        if spacing == "leading":
            ts = np.arange(num_inference_steps) * (T // num_inference_steps)
        elif spacing == "linspace":
            # the float32 values of the JAX package's jnp.linspace as XLA
            # computes them, i * (1/div * (T - 1)) with the last one T - 1,
            # rounded half to even: on a tie (e.g. 832.5 at 31 steps) its
            # rounding errors, not the tie rule, pick the side
            f32 = np.float32
            c = f32(f32(1) / f32(max(num_inference_steps - 1, 1))) * f32(T - 1)
            ts = np.arange(num_inference_steps, dtype=f32) * c
            if num_inference_steps > 1:
                ts[-1] = T - 1
            ts = ts.round()
        else:
            raise ValueError(spacing)
        return ts[::-1].astype(np.int64)

    def step(self, model_output: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """The sample at ``t_prev`` from the model output at ``t`` (host ints;
        ``t_prev < 0`` is the clean end, alpha_bar = 1): x0 and eps from the
        epsilon or v prediction, then sqrt(abar_prev) x0 + sqrt(1 - abar_prev) eps."""
        s = self.sched
        one = np.float32(1.0)
        ac_t = s.alphas_cumprod[int(t)]
        ac_prev = s.alphas_cumprod[int(t_prev)] if t_prev >= 0 else one
        a_t, s_t = float(np.sqrt(ac_t)), float(np.sqrt(one - ac_t))
        if s.prediction_type == "epsilon":
            x0 = (sample - s_t * model_output) / a_t
            eps = model_output
        else:  # v_prediction
            x0 = a_t * sample - s_t * model_output
            eps = a_t * model_output + s_t * sample
        return float(np.sqrt(ac_prev)) * x0 + float(np.sqrt(one - ac_prev)) * eps

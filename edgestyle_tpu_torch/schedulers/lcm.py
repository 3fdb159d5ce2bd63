"""LCM (Latent Consistency Model) sampler, for LCM-LoRA distilled weights.

Counterpart of edgestyle_tpu/schedulers/lcm.py, with diffusers'
scheduling_lcm.py semantics in the SD configuration
(original_inference_steps=50, timestep_scaling=10, sigma_data=0.5,
epsilon prediction, strength 1): each step maps the sample to the
consistency estimate of x0 at its source timestep and re-noises it to the
next grid point; the last step returns the estimate and draws nothing.

The plan is host numpy plus the ``torch.Generator`` the re-noise is drawn
from (the JAX plan carries a key instead, folded with the step index), or
the re-noise itself, drawn by the caller (an exported generate program
takes it as an input). :meth:`LCMScheduler.step` also takes the noise as
an argument, so a caller can feed in any draw. LCM sampling is
guidance-free: pair it with ``cfg_interval=(0.0, 0.0)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.loop import SampleLoop


@dataclasses.dataclass(frozen=True)
class LCMPlan:
    """Per-step tables, each shape (N,), and the re-noise generator."""

    timesteps: np.ndarray
    alpha_s: np.ndarray  # sqrt(alpha_bar) at each step's source
    sigma_s: np.ndarray
    alpha_p: np.ndarray  # ... at the next grid timestep (unread on the last step)
    sigma_p: np.ndarray
    c_skip: np.ndarray   # the consistency boundary scalings at the source
    c_out: np.ndarray
    generator: Optional[torch.Generator]
    noise: Optional[Sequence[torch.Tensor]] = None  # steps 0..N-2's re-noise, else drawn

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


class LCMScheduler(SampleLoop):
    """One model call per step; no multistep history."""

    original_inference_steps = 50  # the distillation grid
    timestep_scaling = 10.0
    sigma_data = 0.5

    def __init__(self, sched: NoiseSchedule):
        self.sched = sched

    def timestep_grid(self, num_inference_steps: int) -> np.ndarray:
        """The LCM grid (set_timesteps at strength 1): the distillation grid
        (i+1) * (T / orig) - 1, descending, sampled by floor-linspace
        indexing."""
        T = self.sched.num_train_timesteps
        orig = self.original_inference_steps
        if num_inference_steps > orig:
            raise ValueError(f"num_inference_steps={num_inference_steps} exceeds the "
                             f"distillation grid ({orig} steps) — LCM cannot sample off "
                             f"the grid it was distilled on")
        origin = np.arange(1, orig + 1, dtype=np.int64) * (T // orig) - 1
        idx = np.floor(np.linspace(0, len(origin), num_inference_steps,
                                   endpoint=False)).astype(np.int64)
        return origin[::-1][idx]

    def plan(self, num_inference_steps: int, generator: Optional[torch.Generator] = None,
             noise: Optional[Sequence[torch.Tensor]] = None) -> LCMPlan:
        """``generator`` draws the re-noise of every step but the last, unless
        ``noise`` gives it (``num_inference_steps - 1`` tensors); a one-step
        plan needs neither."""
        if noise is not None and len(noise) != num_inference_steps - 1:
            raise ValueError(f"{num_inference_steps} LCM steps re-noise {num_inference_steps - 1} "
                             f"times, got {len(noise)} noise tensors")
        ac = np.asarray(self.sched.alphas_cumprod, dtype=np.float64)
        ts = self.timestep_grid(num_inference_steps)
        prev = np.concatenate([ts[1:], [ts[-1]]])
        st = ts.astype(np.float64) * self.timestep_scaling
        sd2 = self.sigma_data ** 2
        f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
        return LCMPlan(
            timesteps=ts.astype(np.int32), alpha_s=f32(np.sqrt(ac[ts])),
            sigma_s=f32(np.sqrt(1.0 - ac[ts])), alpha_p=f32(np.sqrt(ac[prev])),
            sigma_p=f32(np.sqrt(1.0 - ac[prev])), c_skip=f32(sd2 / (st ** 2 + sd2)),
            c_out=f32(st / np.sqrt(st ** 2 + sd2)), generator=generator,
            noise=None if noise is None else list(noise))

    def init_state(self, sample: torch.Tensor) -> Dict:
        return {}

    def step(self, plan: LCMPlan, i: int, model_output, sample, state: Dict,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """The update i -> i+1: the consistency estimate at the source t, then
        the re-noise to the next grid point with ``noise`` (drawn from the
        plan's generator when None); the last step returns the estimate."""
        sample_f32 = sample.float()
        out_f32 = model_output.float()
        a_s, s_s = float(plan.alpha_s[i]), float(plan.sigma_s[i])
        if self.sched.prediction_type == "epsilon":
            x0 = (sample_f32 - s_s * out_f32) / a_s
        else:  # v_prediction
            x0 = a_s * sample_f32 - s_s * out_f32
        denoised = float(plan.c_out[i]) * x0 + float(plan.c_skip[i]) * sample_f32
        if i == plan.num_steps - 1:
            return denoised.to(sample.dtype), state
        if noise is None and plan.noise is not None:
            noise = plan.noise[i]
        if noise is None:
            if plan.generator is None:
                raise ValueError("an LCM plan of more than one step needs a generator "
                                 "for its re-noise")
            noise = torch.randn(sample.shape, generator=plan.generator, device=sample.device,
                                dtype=torch.float32)
        renoised = float(plan.alpha_p[i]) * denoised + float(plan.sigma_p[i]) * noise
        return renoised.to(sample.dtype), state

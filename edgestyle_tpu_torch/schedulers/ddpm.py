"""The SD1.5 noise schedule, and the training-side DDPM functions.

Counterpart of edgestyle_tpu/schedulers/ddpm.py: scaled-linear betas
0.00085 -> 0.012 over 1000 steps. The tables are host numpy float32: the
samplers read them as host scalars, so the denoise loop never waits on the
device. The trainer instead indexes them by device timesteps:
:meth:`NoiseSchedule.to` moves ``alphas_cumprod`` to the device once, and
:func:`add_noise`, :func:`get_velocity`, :func:`training_target` and
:func:`compute_snr` take that :class:`DeviceSchedule`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """``alphas_cumprod`` as an fp32 device tensor, for indexing by device
    timesteps."""

    alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    prediction_type: str


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int = 1000
    prediction_type: str = "epsilon"  # or "v_prediction"

    @staticmethod
    def sd15(num_train_timesteps: int = 1000, prediction_type: str = "epsilon"):
        """scaled_linear(0.00085, 0.012), float32."""
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_train_timesteps,
                            dtype=np.float32) ** 2
        alphas_cumprod = np.cumprod(np.float32(1.0) - betas, dtype=np.float32)
        return NoiseSchedule(betas, alphas_cumprod, num_train_timesteps, prediction_type)

    def to(self, device) -> DeviceSchedule:
        return DeviceSchedule(torch.as_tensor(self.alphas_cumprod, device=device),
                              self.num_train_timesteps, self.prediction_type)


def _coefs(sched: DeviceSchedule, t: torch.Tensor, like: torch.Tensor):
    """sqrt(abar_t) and sqrt(1 - abar_t), fp32, shaped to broadcast over
    ``like``'s trailing dims."""
    ac = sched.alphas_cumprod[t].reshape(-1, *([1] * (like.ndim - 1)))
    return torch.sqrt(ac), torch.sqrt(1.0 - ac)


def add_noise(sched: DeviceSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps (diffusers add_noise)."""
    a, s = _coefs(sched, t, x0)
    return a * x0 + s * noise


def get_velocity(sched: DeviceSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """v = sqrt(abar_t) eps - sqrt(1 - abar_t) x0."""
    a, s = _coefs(sched, t, x0)
    return a * noise - s * x0


def training_target(sched: DeviceSchedule, x0, noise, t):
    if sched.prediction_type == "epsilon":
        return noise
    if sched.prediction_type == "v_prediction":
        return get_velocity(sched, x0, noise, t)
    raise ValueError(f"unknown prediction_type {sched.prediction_type}")


def compute_snr(sched: DeviceSchedule, t: torch.Tensor) -> torch.Tensor:
    """SNR(t) = abar_t / (1 - abar_t)."""
    ac = sched.alphas_cumprod[t]
    return ac / (1.0 - ac)

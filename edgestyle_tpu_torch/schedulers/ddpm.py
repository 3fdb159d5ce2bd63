"""The SD1.5 noise schedule.

Counterpart of edgestyle_tpu/schedulers/ddpm.py (the part the try-on path
uses): scaled-linear betas 0.00085 -> 0.012 over 1000 steps. The tables
are host numpy float32: the samplers read them as host scalars, so the
denoise loop never waits on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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

"""Min-SNR-gamma loss weighting (arXiv:2303.09556).

Counterpart of edgestyle_tpu/training/minsnr.py: weights = min(SNR(t),
gamma) / SNR(t), with SNR + 1 in the divisor for v-prediction.
"""

from __future__ import annotations

import torch

from edgestyle_tpu_torch.schedulers.ddpm import DeviceSchedule, compute_snr


def min_snr_weights(sched: DeviceSchedule, timesteps: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    snr = compute_snr(sched, timesteps)
    if sched.prediction_type == "v_prediction":
        snr = snr + 1.0
    return torch.clamp(snr, max=gamma) / snr


def weighted_mse(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor):
    """Per-sample mean of the fp32 squared error, times the weights, mean
    over the batch: a 0-d tensor."""
    per = (pred.float() - target.float()).square().mean(dim=tuple(range(1, pred.ndim)))
    return (per * weights).mean()

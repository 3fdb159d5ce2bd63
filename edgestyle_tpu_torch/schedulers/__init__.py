"""The samplers and the SD1.5 noise schedule."""

from edgestyle_tpu_torch.schedulers.ddim import DDIMScheduler
from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.dpmsolver import DPMSolverScheduler
from edgestyle_tpu_torch.schedulers.lcm import LCMScheduler
from edgestyle_tpu_torch.schedulers.unipc import UniPCScheduler

__all__ = ["DDIMScheduler", "DPMSolverScheduler", "LCMScheduler", "NoiseSchedule",
           "UniPCScheduler"]

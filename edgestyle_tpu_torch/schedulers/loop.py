"""The denoise loop shared by the multistep schedulers.

Counterpart of edgestyle_tpu/schedulers/loop.py, whose ``lax.scan`` becomes
a Python loop: the per-step coefficients are host scalars from the plan, so
each step only enqueues device work and the loop never synchronises.
"""

from __future__ import annotations


class SampleLoop:
    def sample_loop(self, plan, model_fn, init_noise, model_state=None):
        """Run the denoise loop. ``model_fn(sample, t, i)`` returns the raw
        model output at step i, for host int timestep t; init_noise is a
        standard-normal latent (init sigma 1). With ``model_state`` (the
        pipeline's caches), ``model_fn(sample, t, i, state)`` returns
        ``(output, new_state)`` and the state is carried from step to step,
        as the JAX loop carries it through the scan."""
        sample = init_noise
        state = self.init_state(init_noise)
        for i in range(plan.num_steps):
            t = int(plan.timesteps[i])
            if model_state is None:
                out = model_fn(sample, t, i)
            else:
                out, model_state = model_fn(sample, t, i, model_state)
            sample, state = self.step(plan, i, out, sample, state)
        return sample

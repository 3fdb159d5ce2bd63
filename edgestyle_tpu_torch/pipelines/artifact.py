"""Serve and generate from exported deployment artifacts.

Counterpart of edgestyle_tpu/pipelines/artifact.py (the reference's second
serving path, app-onnx.py with its ONNX pipeline: exported text encode, a
UNet + ControlNet graph called once a step, a host-side scheduler, an
exported VAE decode). Two artifact shapes, both from apps/export.py:

* **Whole-generation program** (``generate.pt2`` + ``serving.json``, from
  ``--what generate [--mode ...]``): the whole generation (text encode,
  cond embedding, the denoise steps with any serving knobs baked in, VAE
  decode) is one ``torch.export`` program of the live pipeline's
  ``__call__``. The baked knobs are recorded in ``serving.json`` and a
  request is checked against them (:meth:`ArtifactPipeline._check_baked`).
* **Host loop over per-stage graphs** (``text_encoder``, ``cond_embed``,
  ``unet_controlnet``, ``vae_decoder``, from ``--what all``): the port's
  UniPC or DPM-Solver++ runs on the host and calls the denoise graph once
  a step, so any step count or either sampler serves from one artifact
  directory; it runs exact semantics only and refuses serving knobs. Each
  graph takes the part of the params it reads (:func:`stage_params`).

Randomness: the JAX package passes key data. Here the caller's
``torch.Generator`` draws the initial latents (or the caller passes them),
exactly as ``EdgeStylePipeline._generate`` does, and, for an LCM generate
program, the re-noise of every step but the last after them, as the live
LCM sampler draws it. So an artifact and the live pipeline give the same
image for the same seed. The graphs run on the device they were exported
on; inputs are moved to ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device
from edgestyle_tpu_torch.core.export import load_program
from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.dpmsolver import DPMSolverScheduler
from edgestyle_tpu_torch.schedulers.unipc import UniPCScheduler

GRAPHS = ("text_encoder", "cond_embed", "unet_controlnet", "vae_decoder")
GENERATE_GRAPH = "generate.pt2"
SERVING_JSON = "serving.json"

# serving knobs baked into a generate program, with their exact-semantics
# defaults: a request's knobs are checked against the baked values
_BAKED_KNOBS = {
    "cfg_interval": (0.0, 1.0),
    "controlnet_cache_interval": 1,
    "unet_cache_interval": 1,
    "controlnet_cache_steps": None,
    "unet_cache_steps": None,
}

# the positional arguments of the two programs that a call draws
_GEN_LATENTS, _GEN_RENOISE = 4, 5  # generate(p, ids, neg, imgs, latents, renoise, guidance)
_STEP_SAMPLE = 1  # unet_controlnet(p, sample, t, context, embs, guidance)


def stage_params(name: str, params):
    """The part of the pipeline's params that the program ``name`` reads.
    Each per-stage graph takes its part alone: every leaf it is given is a
    placeholder node of its graph, and nodes cost trace, save and load
    time. The generate program takes the whole tree."""
    if name == "text_encoder":
        return {"clip": params["clip"]}
    if name in ("vae_encoder", "vae_decoder"):
        return {"vae": params["vae"]}
    if name == "cond_embed":
        static = params["controlnet"]["static"]
        return {"vae": params["vae"], "unet": {"conv_in": params["unet"]["conv_in"]},
                "controlnet": {"static": {
                    "controlnet_cond_embedding": static["controlnet_cond_embedding"]}}}
    if name == "unet_controlnet":
        return {"unet": params["unet"], "controlnet": params["controlnet"]}
    return params


def _norm_knob(v):
    return tuple(v) if isinstance(v, list) else v


class ArtifactPipeline:
    """Try-on generation from an apps/export.py artifact directory, called
    as ``EdgeStylePipeline.__call__`` is: (params, ids, negative ids, cond
    images, generator, steps, guidance, latents, serving knobs) -> (B, 3,
    H, W) images in [0, 1]."""

    def __init__(self, artifact_dir: str, scheduler: str = "unipc",
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.graphs = {}
        self.serving = None
        gen_path = os.path.join(artifact_dir, GENERATE_GRAPH)
        if os.path.exists(gen_path):
            # one-program mode: the knobs are baked in and recorded
            self.graphs["generate"] = load_program(gen_path)
            sj = os.path.join(artifact_dir, SERVING_JSON)
            self.serving = {}
            if os.path.exists(sj):
                with open(sj) as f:
                    self.serving = json.load(f)
            prog = self.graphs["generate"]
            self.latent_shape = prog.arg_meta(_GEN_LATENTS)[0][0]
            self.renoise_count = len(prog.arg_meta(_GEN_RENOISE))
            self.image_shape = prog.out_meta[-1][0]
            return
        for name in GRAPHS:
            path = os.path.join(artifact_dir, f"{name}.pt2")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} missing — run apps/export.py --what all (or "
                    f"--what generate for the one-program artifact) first")
            self.graphs[name] = load_program(path)
        if scheduler == "unipc":
            self.scheduler = UniPCScheduler(NoiseSchedule.sd15())
        elif scheduler in ("dpm++", "dpmsolver++"):
            self.scheduler = DPMSolverScheduler(NoiseSchedule.sd15())
        else:
            raise ValueError(f"unknown scheduler {scheduler!r} (expected 'unipc' or 'dpm++')")
        # the denoise graph's sample input fixes the latent geometry
        self.latent_shape = self.graphs["unet_controlnet"].arg_meta(_STEP_SAMPLE)[0][0]

    @property
    def one_program(self) -> bool:
        return "generate" in self.graphs

    def _check_baked(self, num_inference_steps, knobs):
        """Validate a request against the generate program's baked config."""
        baked_steps = self.serving.get("num_inference_steps")
        if baked_steps is not None and num_inference_steps != baked_steps:
            raise ValueError(
                f"this generate artifact is baked at "
                f"{baked_steps} steps (serving.json); requested "
                f"{num_inference_steps}. Re-export with --steps, or use a "
                f"--what all artifact for variable step counts.")
        for name, default in _BAKED_KNOBS.items():
            baked = _norm_knob(self.serving.get(name, default))
            req = _norm_knob(knobs.get(name, default))
            if req is None:
                req = default
            if req != baked:
                raise ValueError(
                    f"this generate artifact bakes {name}={baked} "
                    f"(serving.json mode={self.serving.get('mode')!r}); "
                    f"requested {name}={req}. Re-export with the wanted "
                    f"knobs baked in.")

    def _randn(self, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(self.latent_shape, generator=generator, device=self.device,
                           dtype=torch.float32)

    @torch.no_grad()
    def __call__(self, params, prompt_ids, negative_prompt_ids,
                 cond_images: Sequence[torch.Tensor],
                 generator: Optional[torch.Generator] = None, num_inference_steps: int = 20,
                 guidance_scale=3.5, latents: Optional[torch.Tensor] = None, **serving_knobs):
        dev = self.device
        if generator is None:  # the live pipeline's default: seed 0 on the device
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        if self.one_program:
            self._check_baked(num_inference_steps, serving_knobs)
        else:
            bad = {k: v for k, v in serving_knobs.items()
                   if _norm_knob(v) not in (None, _BAKED_KNOBS.get(k))}
            if bad:
                raise ValueError(
                    f"the host-loop artifact path runs exact semantics only; "
                    f"got serving knobs {bad}. Export a one-program artifact "
                    f"(apps/export.py --what generate --mode ...) to serve "
                    f"these knobs from an artifact.")
        ids = torch.as_tensor(prompt_ids, device=dev).long()
        neg = torch.as_tensor(negative_prompt_ids, device=dev).long()
        imgs = [torch.as_tensor(im).to(dev, torch.float32)
                .contiguous(memory_format=torch.channels_last) for im in cond_images]
        sample = self._randn(generator) if latents is None else latents
        sample = sample.to(dev, torch.float32).contiguous(memory_format=torch.channels_last)
        g = torch.as_tensor(guidance_scale, dtype=torch.float32, device=dev)
        if self.one_program:
            renoise = [self._randn(generator) for _ in range(self.renoise_count)]
            return self.graphs["generate"].call(params, ids, neg, imgs, sample, renoise, g)
        ctx = self.graphs["text_encoder"].call(stage_params("text_encoder", params), ids, neg)
        embs = list(self.graphs["cond_embed"].call(stage_params("cond_embed", params), imgs))
        plan = self.scheduler.plan(num_inference_steps)
        # the step's timestep is a graph input: one copy of the plan's to the
        # device, so the loop never synchronises
        ts = torch.as_tensor(plan.timesteps, dtype=torch.long).to(dev)
        step, step_params = self.graphs["unet_controlnet"], stage_params("unet_controlnet", params)

        def model_fn(x, t, i):
            return step.call(step_params, x, ts[i], ctx, embs, g)

        final = self.scheduler.sample_loop(plan, model_fn, sample)
        return self.graphs["vae_decoder"].call(stage_params("vae_decoder", params), final)

"""End-to-end try-on generation.

Counterpart of edgestyle_tpu/pipelines/tryon.py, exact path: CLIP encode
of [negative; prompt] for CFG -> one-time embedding of the N control
images (VAE encode x3 into the UNet's tied ``conv_in`` for the ControlLoRA
branches, the conv-stack embedding x3 for the openpose branches) -> UniPC
steps, each running the multi-branch ControlNet as batched trunk calls,
the fusion blocks, the UNet with the injected residuals and the CFG
combine -> VAE decode -> [0, 1] images.

Tensors are NCHW (channels_last); images (B, 3, H, W), latents
(B, 4, H/8, W/8). The pipeline runs on ``device`` (default the card).

The serving knobs of the JAX package are here too, each an opt-in
approximation whose exact-semantics value runs the exact program: the
samplers (``PipelineConfig.scheduler``: UniPC, DPM-Solver++ 2M, LCM), ToMe
(``tome``), ``cfg_interval`` and the ControlNet-residual and UNet
deep-feature caches (``controlnet_cache_interval`` / ``_steps``,
``unet_cache_interval`` / ``_steps``). So is W8A8 int8 serving of the
denoise step (``quant``, default ``EDGESTYLE_QUANT``; ops/quant.py):
``"int8"`` quantises activations dynamically, ``"int8-static"`` with a
per-layer table that :meth:`EdgeStylePipeline.calibrate_int8` records (on
the first request when none is loaded; :meth:`save_int8_scales` /
:meth:`load_int8_scales` keep it as JSON, in the JAX package's format and
keys). The weights are quantised after the prompt and the control images
are encoded, and kept on the pipeline for the next generation while they
are the same, unwritten tensors; every model call of the step loop runs
inside ``quantize_intercept``. Several cards: :meth:`generate_dp` (batch
rows over the ``data`` ranks) and :meth:`generate_tp` (attention and
feed-forward kernels over the ``model`` ranks, core/partitioning.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.device import (
    DeviceLike,
    make_generator,
    resolve_device,
    torch_dtype,
)
from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.mesh import MODEL_AXIS, gather_rows, rows
from edgestyle_tpu_torch.core.params import InitTree, flatten, materialize, sub
from edgestyle_tpu_torch.core.partitioning import shard_params_tp
from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from edgestyle_tpu_torch.models.multicontrolnet import EdgeStyleMultiControlNet, edgestyle_fusion
from edgestyle_tpu_torch.models.unet import (
    SD15UNet,
    UNetConfig,
    controllora_params,
    init_lora_params,
    split_trunk_params,
)
from edgestyle_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from edgestyle_tpu_torch.ops import tp
from edgestyle_tpu_torch.ops.quant import (
    is_prequant,
    quantize_denoise_params,
    quantize_intercept,
    recording,
)
from edgestyle_tpu_torch.ops.tome import ToMeConfig
from edgestyle_tpu_torch.schedulers.ddpm import NoiseSchedule
from edgestyle_tpu_torch.schedulers.dpmsolver import DPMSolverScheduler
from edgestyle_tpu_torch.schedulers.lcm import LCMScheduler
from edgestyle_tpu_torch.schedulers.unipc import UniPCScheduler

DEFAULT_STEPS = 20
QUANT_MODES = ("none", "int8", "int8-static")
SCHEDULERS = {"unipc": UniPCScheduler, "dpm++": DPMSolverScheduler,
              "dpmsolver++": DPMSolverScheduler, "lcm": LCMScheduler}


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clip: CLIPTextConfig = CLIPTextConfig()
    # integer id -> that ControlLoRA (VAE-latent cond), None -> the shared
    # conv-cond ControlNet; the 4-branch legacy layout is (0, None, 1, None)
    pattern: tuple = (0, None, 1, None, 1, None)
    dtype: str = "bfloat16"
    # "unipc" (the reference app's), "dpm++" / "dpmsolver++" (DPM-Solver++
    # 2M) or "lcm" (few-step sampling of LCM-LoRA weights; pair it with
    # cfg_interval=(0.0, 0.0))
    scheduler: str = "unipc"

    @property
    def num_branches(self) -> int:
        return len(self.pattern)

    @property
    def latent_branches(self) -> tuple:
        return tuple(p for p, pid in enumerate(self.pattern) if pid is not None)


def _timesteps(t, rows: int, device) -> torch.Tensor:
    """(rows,) long timesteps from a host int (the live loop's) or a 0-d
    tensor (the input of an exported denoise step, apps/export.py)."""
    if isinstance(t, torch.Tensor):
        return t.to(device, torch.long).reshape(1).expand(rows)
    return torch.full((rows,), t, dtype=torch.long, device=device)


def _version(leaf) -> Optional[int]:
    """A tensor's in-place write counter; None for a leaf without one (an
    inference-mode tensor, a non-tensor)."""
    try:
        return leaf._version
    except (AttributeError, RuntimeError):
        return None


class EdgeStylePipeline:
    """params: {'vae', 'clip', 'unet', 'controlnet': {'static', 'lora_0',
    'lora_1', 'fusion'}}, in the port's layout (core/porting.py).

    ``tome``: a merge ratio (0 is exact) or an ops/tome.py::ToMeConfig, for
    the transformer blocks of the UNet and the ControlNet trunks. ``quant``:
    "none", "int8" or "int8-static" (W8A8 serving of the denoise step), by
    default the ``EDGESTYLE_QUANT`` environment variable's, else "none"."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(), device: DeviceLike = "cuda",
                 quant: Optional[str] = None, tome=None):
        self.quant = quant if quant is not None else os.environ.get("EDGESTYLE_QUANT", "none")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.quant!r} (expected one of {QUANT_MODES})")
        self._int8_scales: Optional[Dict[str, float]] = None  # the int8-static table
        self._int8_weights = None  # (leaves, their versions, the quantised trees)
        if isinstance(tome, (int, float)) and not isinstance(tome, bool):
            tome = ToMeConfig(ratio=float(tome)) if float(tome) > 0 else None
        if tome is not None and not isinstance(tome, ToMeConfig):
            raise ValueError(f"tome must be a ratio or ToMeConfig, got {tome!r}")
        if cfg.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {cfg.scheduler!r} "
                             f"(expected 'unipc', 'dpm++' or 'lcm')")
        self.cfg = cfg
        self.tome = tome
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        self.vae = AutoencoderKL(cfg.vae, self.dtype)
        self.clip = CLIPTextEncoder(cfg.clip, self.dtype)
        self.unet = SD15UNet(cfg.unet, dtype=self.dtype, tome=tome)
        self.mcn = EdgeStyleMultiControlNet(cfg.unet, cfg.pattern, self.dtype, tome=tome)
        self.scheduler = SCHEDULERS[cfg.scheduler](NoiseSchedule.sd15())
        self.vae_downscale = 2 ** (len(cfg.vae.block_out_channels) - 1)

    # ------------------------------------------------------------------
    def record_params(self) -> InitTree:
        """Every model's forward run once on the meta device, recording its
        params (shapes, init rules, which stay fp32): the tree
        :meth:`init_params` draws, without its ControlLoRA branches (each
        the UNet's trunk and the static net's ``controlnet_*`` subtrees)."""
        cfg = self.cfg
        meta = torch.device("meta")
        s = cfg.vae.sample_size
        hw = s // self.vae_downscale
        img = torch.zeros((1, 3, s, s), device=meta)
        lat = torch.zeros((1, cfg.unet.in_channels, hw, hw), device=meta)
        t = torch.zeros((1,), dtype=torch.long, device=meta)
        ctx = torch.zeros((1, cfg.clip.max_positions, cfg.clip.hidden_size), device=meta)
        ids = torch.zeros((1, cfg.clip.max_positions), dtype=torch.long, device=meta)
        emb = torch.zeros((1, cfg.unet.block_out_channels[0], hw, hw), device=meta)

        tree = InitTree()
        self.vae(sub(tree, "vae"), img)
        self.clip(sub(tree, "clip"), ids)
        self.unet(sub(tree, "unet"), lat, t, ctx)
        cn = sub(tree, "controlnet")
        static = sub(cn, "static")
        down, mid = self.mcn.branch.controlnet_forward(static, lat, t, ctx, emb)
        self.mcn.branch.embed_cond(static, img)
        n = cfg.num_branches
        edgestyle_fusion(sub(cn, "fusion"), [list(down)] * n, [mid] * n,
                         self.mcn.down_channels, cfg.unet.block_out_channels[-1], self.dtype)
        return tree

    def init_params(self, generator: torch.Generator) -> Dict:
        """The port's own random init, in the JAX tree layout: the recorded
        params (:meth:`record_params`) drawn from ``generator`` (on this
        pipeline's device). ControlNet heads and the cond embedding's
        conv_out start at zero, LoRA ups at zero, as in JAX."""
        params = materialize(self.record_params(), generator, self.dtype)

        heads = {k: v for k, v in params["controlnet"]["static"].items()
                 if k.startswith("controlnet_")}
        trunk = split_trunk_params(params["unet"])
        for key in sorted({g.params_key for g in self.mcn.groups if g.kind == "lora"}):
            params["controlnet"][key] = controllora_params(
                params["unet"], init_lora_params(generator, trunk, rank=32), heads)
        return params

    # ------------------------------------------------------------------
    def encode_prompt(self, params, prompt_ids, negative_prompt_ids):
        """(B, n) ids each -> (2B, n, C) [uncond; cond]."""
        ids = torch.cat([negative_prompt_ids, prompt_ids], dim=0)
        return self.clip(params["clip"], ids)["last_hidden_state"]

    def embed_cond_images(self, params, cond_images: Sequence[torch.Tensor],
                          generator: Optional[torch.Generator] = None):
        """N (B, 3, H, W) images -> N (B, 320, H/8, W/8) embeddings. VAE
        branches: encode (posterior mode without a generator) * scaling
        factor -> the UNet's conv_in in fp32 (the JAX package applies the
        fp32 params there); the others: the conv-stack embedding."""
        cfg = self.cfg
        b = cond_images[0].shape[0]
        latent_pos = list(cfg.latent_branches)
        conv_pos = [p for p in range(cfg.num_branches) if p not in latent_pos]
        out: Dict[int, torch.Tensor] = {}
        if latent_pos:
            stacked = torch.cat([cond_images[p] for p in latent_pos], dim=0)
            lat = self.vae.encode(params["vae"], stacked, generator) * cfg.vae.scaling_factor
            conv_in = params["unet"]["conv_in"]
            emb = F.conv2d(lat.float(), conv_in["kernel"].float(), conv_in["bias"].float(),
                           padding=1)
            for j, p in enumerate(latent_pos):
                out[p] = emb[j * b:(j + 1) * b]
        if conv_pos:
            stacked = torch.cat([cond_images[p] for p in conv_pos], dim=0)
            emb = self.mcn.branch.embed_cond(params["controlnet"]["static"], stacked)
            for j, p in enumerate(conv_pos):
                out[p] = emb[j * b:(j + 1) * b]
        return [out[p] for p in range(cfg.num_branches)]

    # ------------------------------------------------------------------
    def _residual_step(self, params, context, embs, embs2, scales_i, b, guess_mode,
                       sample, t: int, use_cfg: bool = True):
        """The multi-branch ControlNet for one step, CFG-doubled to 2B rows.
        In guess mode only the conditional half runs; the uncond half gets
        zero residuals. With ``use_cfg`` off (a CFG-off step of
        ``cfg_interval``) only the conditional half runs, at B rows."""
        dev = sample.device
        if not use_cfg or guess_mode:
            tb = _timesteps(t, b, dev)
            down, mid = self.mcn(params["controlnet"], sample, tb, context[b:], embs, scales_i,
                                 guess_mode=guess_mode)
            if not use_cfg:
                return down, mid
            down = tuple(torch.cat([torch.zeros_like(d), d], dim=0) for d in down)
            return down, torch.cat([torch.zeros_like(mid), mid], dim=0)
        x2 = torch.cat([sample, sample], dim=0)
        t2 = _timesteps(t, 2 * b, dev)
        return self.mcn(params["controlnet"], x2, t2, context, embs2, scales_i)

    def _eval_step(self, use_cfg: bool, params, context, embs, embs2, scales_i, g, b,
                   guess_mode, sample, t: int, cache=None, refresh_cn: bool = True,
                   refresh_deep: bool = True):
        """One denoise-model evaluation: the ControlNets, the UNet and the
        CFG combine; with ``use_cfg`` off both run at B rows on the
        conditional context and the conditional prediction is the output
        (CFG at guidance 1.0).

        ``cache`` is None (the exact path) or a dict carried from step to
        step, updated in place, with any of:
          'cn'   -- the fused residuals at 2B rows, recomputed only on steps
                    with ``refresh_cn``;
          'deep' -- the UNet's deep feature at 2B rows, recaptured only on
                    steps with ``refresh_deep``; the others run
                    ``SD15UNet.shallow_forward`` on it.
        A refresh on a CFG-off step stores its B rows in both halves (zeros
        in the uncond half of the residuals in guess mode, as guess mode
        mandates); a CFG-off step reads the conditional half."""
        cn_cached = cache is not None and "cn" in cache
        if refresh_cn or not cn_cached:
            down, mid = self._residual_step(params, context, embs, embs2, scales_i, b,
                                            guess_mode, sample, t, use_cfg)
            if cn_cached and use_cfg:
                cache["cn"] = (down, mid)
            elif cn_cached:
                pad = torch.zeros_like if guess_mode else (lambda x: x)
                cache["cn"] = (tuple(torch.cat([pad(x), x], dim=0) for x in down),
                               torch.cat([pad(mid), mid], dim=0))
        elif use_cfg:
            down, mid = cache["cn"]
        else:
            down, mid = tuple(x[b:] for x in cache["cn"][0]), cache["cn"][1][b:]
        dev = sample.device
        rows = 2 * b if use_cfg else b
        x2 = torch.cat([sample, sample], dim=0) if use_cfg else sample
        t2 = _timesteps(t, rows, dev)
        ctx = context if use_cfg else context[b:]
        if cache is not None and "deep" in cache:
            if refresh_deep:
                noise, deep = self.unet(params["unet"], x2, t2, ctx,
                                        down_block_additional_residuals=down,
                                        mid_block_additional_residual=mid, return_deep=True)
                cache["deep"] = deep if use_cfg else torch.cat([deep, deep], dim=0)
            else:
                deep = cache["deep"] if use_cfg else cache["deep"][b:]
                noise = self.unet.shallow_forward(params["unet"], x2, t2, ctx, deep,
                                                  down_block_additional_residuals=down)
        else:
            noise = self.unet(params["unet"], x2, t2, ctx,
                              down_block_additional_residuals=down,
                              mid_block_additional_residual=mid)
        if not use_cfg:
            return noise.float()
        uncond, cond = noise.chunk(2, dim=0)
        return uncond + g * (cond - uncond)

    def _generate(self, params, prompt_ids, negative_prompt_ids, cond_images, generator,
                  num_inference_steps: int, guidance_scale, scales: np.ndarray, latents,
                  guess_mode: bool, cfg_on=None, cn_sched=None, deep_sched=None,
                  lcm_noise=None):
        """``cfg_on``: None (CFG every step, the exact program), "off" (no
        step) or a (steps,) host bool mask; ``cn_sched`` / ``deep_sched``:
        None (no cache) or (steps,) host bool refresh masks, True at step 0
        (:meth:`_schedules`). Under int8 the denoise weights are quantised
        here (:meth:`_quantized`: once for a set of weights), after the
        prompt and control images are encoded, and each step's model calls
        run in ``quantize_intercept`` (with the static table under
        "int8-static")."""
        cfg = self.cfg
        dev = self.device
        b = prompt_ids.shape[0]
        int8 = self.quant.startswith("int8")
        static = self._quant_scales_static() if self.quant == "int8-static" else None
        context = self.encode_prompt(params, prompt_ids, negative_prompt_ids)
        embs = self.embed_cond_images(params, cond_images)
        embs2 = [torch.cat([e, e], dim=0) for e in embs]
        if int8:
            params = self._quantized(params)
        if latents is None:
            h = cond_images[0].shape[2] // self.vae_downscale
            w = cond_images[0].shape[3] // self.vae_downscale
            latents = torch.randn((b, cfg.unet.in_channels, h, w), generator=generator,
                                  device=dev, dtype=torch.float32)
        if isinstance(self.scheduler, LCMScheduler):
            # the re-noise continues the latents' generator (or a fresh one
            # from seed 0, as the JAX pipeline's default key)
            if generator is None and lcm_noise is None:
                generator = torch.Generator(device=dev)
                generator.manual_seed(0)
            plan = self.scheduler.plan(num_inference_steps, generator, noise=lcm_noise)
        else:
            plan = self.scheduler.plan(num_inference_steps)
        latents = latents.to(dev, torch.float32).contiguous(memory_format=torch.channels_last)
        g = torch.as_tensor(guidance_scale, dtype=torch.float32, device=dev)
        if g.ndim:
            g = g.reshape(b, 1, 1, 1)

        def use_cfg(i):
            return True if cfg_on is None else (False if isinstance(cfg_on, str)
                                                else bool(cfg_on[i]))

        if cn_sched is None and deep_sched is None:
            def model_fn(sample, t, i):
                with quantize_intercept(int8, static_scales=static):
                    return self._eval_step(use_cfg(i), params, context, embs, embs2, scales[i],
                                           g, b, guess_mode, sample, t)

            final = self.scheduler.sample_loop(plan, model_fn, latents)
        else:
            def model_fn(sample, t, i, cache):
                with quantize_intercept(int8, static_scales=static):
                    out = self._eval_step(
                        use_cfg(i), params, context, embs, embs2, scales[i], g, b, guess_mode,
                        sample, t, cache, refresh_cn=cn_sched is None or bool(cn_sched[i]),
                        refresh_deep=deep_sched is None or bool(deep_sched[i]))
                return out, cache

            # step 0 always refreshes, so the caches start empty
            cache = {}
            if cn_sched is not None:
                cache["cn"] = None
            if deep_sched is not None:
                cache["deep"] = None
            final = self.scheduler.sample_loop(plan, model_fn, latents, model_state=cache)
        img = self.vae.decode(params["vae"], final / cfg.vae.scaling_factor)
        return torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def __call__(self, params, prompt_ids, negative_prompt_ids,
                 cond_images: Sequence[torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 num_inference_steps: int = DEFAULT_STEPS,
                 guidance_scale=3.5, conditioning_scale: Optional[Sequence[float]] = None,
                 latents: Optional[torch.Tensor] = None, guess_mode: bool = False, control_guidance_start=0.0,
                 control_guidance_end=1.0, controlnet_cache_interval: int = 1,
                 unet_cache_interval: int = 1, cfg_interval=(0.0, 1.0),
                 controlnet_cache_steps=None, unet_cache_steps=None, lcm_noise=None):
        """Generate try-on images (B, 3, H, W) in [0, 1]. Defaults follow the reference app: 20 steps, guidance
        3.5. ``guidance_scale`` is a scalar or (B,); the control guidance
        window becomes a per-step keep mask folded into the per-branch
        conditioning scales on the host (``_step_scales``).

        The serving knobs (opt-in approximations, as in the JAX package):
        ``controlnet_cache_interval`` k > 1 runs the ControlNets every k-th
        step and reuses their residuals in between; ``unet_cache_interval``
        k > 1 runs the UNet's deep levels every k-th step and
        ``shallow_forward`` in between; ``controlnet_cache_steps`` /
        ``unet_cache_steps`` name the refresh steps instead (0 among them,
        each exclusive with its interval); ``cfg_interval`` (start, end)
        applies CFG only on the steps i with i/N >= start and (i+1)/N <= end
        and runs the others at B rows on the conditional context (an empty
        window, canonically (0, 0), turns CFG off). 1, None and (0, 1) are
        the exact program.

        ``guidance_scale`` may also be a tensor (a generate program's input,
        apps/export.py), and ``lcm_noise`` the LCM sampler's re-noise of
        every step but the last (``num_inference_steps - 1`` latents-shaped
        tensors), which is otherwise drawn from ``generator`` after the
        latents."""
        with spans.span(spans.GEN):
            cfg_on, cn_sched, deep_sched = self._schedules(
                num_inference_steps, controlnet_cache_interval, unet_cache_interval, cfg_interval,
                controlnet_cache_steps, unet_cache_steps)
            dev = self.device
            prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
            negative_prompt_ids = torch.as_tensor(negative_prompt_ids, device=dev).long()
            cond_images = [torch.as_tensor(im).to(dev, torch.float32)
                           .contiguous(memory_format=torch.channels_last) for im in cond_images]
            self._check_inputs(prompt_ids, negative_prompt_ids, cond_images,
                               num_inference_steps, latents)
            scales = self._step_scales(num_inference_steps, conditioning_scale,
                                       control_guidance_start, control_guidance_end)
            g = (guidance_scale if isinstance(guidance_scale, torch.Tensor)
                 else np.asarray(guidance_scale, np.float32))
            if g.ndim not in (0, 1) or (g.ndim == 1 and g.shape[0] != prompt_ids.shape[0]):
                raise ValueError(f"guidance_scale must be a scalar or (B,), got {tuple(g.shape)} "
                                 f"for B={prompt_ids.shape[0]}")
            if self.quant == "int8-static" and self._int8_scales is None:
                # lazy calibration on the first request's own inputs
                self.calibrate_int8(params, prompt_ids, negative_prompt_ids, cond_images)
            return self._generate(params, prompt_ids, negative_prompt_ids, cond_images, generator,
                                  num_inference_steps, g, scales, latents, guess_mode,
                                  cfg_on=cfg_on, cn_sched=cn_sched, deep_sched=deep_sched,
                                  lcm_noise=lcm_noise)

    @staticmethod
    def _schedules(num_steps: int, controlnet_cache_interval, unet_cache_interval,
                   cfg_interval, controlnet_cache_steps, unet_cache_steps):
        """The knobs, checked as the JAX pipeline checks them (the same
        ValueErrors), -> (cfg_on, cn_sched, deep_sched) host schedules; each
        is None where the knob is at its exact value."""
        for name, val in (("controlnet_cache_interval", controlnet_cache_interval),
                          ("unet_cache_interval", unet_cache_interval)):
            if not isinstance(val, int) or val < 1:
                raise ValueError(f"{name} must be an int >= 1, got {val!r}")

        def norm_steps(name, steps, interval):
            if steps is None:
                return None
            if interval != 1:
                raise ValueError(f"{name} and its interval knob are mutually exclusive "
                                 f"(got explicit steps with interval={interval})")
            try:
                steps = tuple(sorted({int(s) for s in steps}))
            except (TypeError, ValueError):
                raise ValueError(f"{name} must be an iterable of ints, got {steps!r}")
            if not steps or steps[0] != 0:
                raise ValueError(f"{name} must include step 0 (the cache seed is only "
                                 f"valid once refreshed), got {steps!r}")
            if steps[-1] >= num_steps:
                raise ValueError(f"{name} entries must be < num_inference_steps="
                                 f"{num_steps}, got {steps!r}")
            return steps

        def refresh_mask(interval, steps):
            if steps is None:
                if interval <= 1:
                    return None
                steps = range(0, num_steps, interval)
            mask = np.zeros((num_steps,), bool)
            mask[list(steps)] = True
            return None if mask.all() else mask

        cn_steps = norm_steps("controlnet_cache_steps", controlnet_cache_steps,
                              controlnet_cache_interval)
        deep_steps = norm_steps("unet_cache_steps", unet_cache_steps, unet_cache_interval)
        try:
            start, end = float(cfg_interval[0]), float(cfg_interval[1])
        except (TypeError, ValueError, IndexError):
            raise ValueError(f"cfg_interval must be a (start, end) pair of fractions, "
                             f"got {cfg_interval!r}")
        if not 0.0 <= start <= end <= 1.0:
            raise ValueError(f"cfg_interval needs 0 <= start <= end <= 1, got {(start, end)}")
        si = np.arange(num_steps, dtype=np.float32)
        active = ~((si / num_steps < start) | ((si + 1) / num_steps > end))
        cfg_on = None if active.all() else ("off" if not active.any() else active)
        return (cfg_on, refresh_mask(controlnet_cache_interval, cn_steps),
                refresh_mask(unet_cache_interval, deep_steps))

    def generate_dp(self, mesh, params, prompt_ids, negative_prompt_ids,
                    cond_images: Sequence[torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    latents: Optional[torch.Tensor] = None, **kwargs):
        """Data-parallel batch generation over the ranks of ``mesh``
        (core/mesh.py): the counterpart of the JAX package's
        ``generate_dp``.

        Every rank passes the global batch and the same ``params`` (once
        :func:`~edgestyle_tpu_torch.core.mesh.replicate_params` has made
        them the same), runs :meth:`__call__` on its rows (B / data of
        them, by its ``data`` coordinate) and returns the global (B, 3, H,
        W) images, gathered over the data group. The noise is the
        single-process noise: each rank draws the global initial latents
        (and LCM's re-noise) from ``generator`` and takes its rows, so
        ``generator`` or ``latents`` must be given; a per-sample
        ``guidance_scale`` and ``lcm_noise`` are sliced the same way, and an
        "int8-static" table is calibrated on the global batch. Raises
        ValueError when B does not divide the data axis."""
        if generator is None and latents is None:
            raise ValueError("generate_dp needs a generator or latents: every rank draws the "
                             "same global noise and takes its rows")
        dev = self.device
        b = prompt_ids.shape[0]
        sl = rows(mesh, b)
        cond_images = [torch.as_tensor(im).to(dev, torch.float32) for im in cond_images]
        if latents is None:
            latents = torch.randn(
                (b, self.cfg.unet.in_channels, cond_images[0].shape[2] // self.vae_downscale,
                 cond_images[0].shape[3] // self.vae_downscale),
                generator=generator, device=dev, dtype=torch.float32)
        steps = kwargs.get("num_inference_steps", DEFAULT_STEPS)
        if isinstance(self.scheduler, LCMScheduler) and steps > 1 and \
                kwargs.get("lcm_noise") is None:
            noise_gen = generator if generator is not None else make_generator(0, dev)
            kwargs["lcm_noise"] = [torch.randn(latents.shape, generator=noise_gen, device=dev,
                                               dtype=torch.float32) for _ in range(steps - 1)]
        if kwargs.get("lcm_noise") is not None:
            kwargs["lcm_noise"] = [n[sl] for n in kwargs["lcm_noise"]]
        g = kwargs.get("guidance_scale")
        if g is not None and np.ndim(g) == 1:
            kwargs["guidance_scale"] = g[sl]
        if self.quant == "int8-static" and self._int8_scales is None:
            self.calibrate_int8(params, prompt_ids, negative_prompt_ids, cond_images)
        local = self(params, prompt_ids[sl], negative_prompt_ids[sl],
                     [im[sl] for im in cond_images], generator=generator, latents=latents[sl],
                     **kwargs)
        return gather_rows(mesh, local, b)

    def generate_tp(self, mesh, params, prompt_ids, negative_prompt_ids,
                    cond_images: Sequence[torch.Tensor], **kwargs):
        """Tensor-parallel (and, with a ``data`` axis above 1, DP x TP)
        generation: the counterpart of the JAX package's ``generate_tp``.

        Each rank keeps its ``model`` coordinate's slices of the attention
        and feed-forward kernels of every submodel
        (core/partitioning.py::shard_params_tp; the VAE's single-head
        attention stays whole) and runs :meth:`generate_dp` inside
        ``ops.tp.model_parallel``: attention on num_heads / tp local heads,
        one all-reduce after each row-parallel Dense (3 a transformer
        block, 1 a CLIP layer). The result equals the single-process one up
        to the reduction order. The knobs pass through.

        Under int8 the denoise weights are quantised whole first
        (:meth:`_quantized`) and then sliced, so every rank keeps the full
        kernels' per-channel scales (core/partitioning.py::local_shard),
        and each row-parallel Dense runs its int8 product on its shard with
        the whole activation's scale and sums the int32 accumulators
        (ops/quant.py::quant_dense_row_parallel): the int8 products are
        the single process's, and the denoise step and an "int8-static"
        table recorded here are too wherever the attentions on num_heads /
        tp heads round as on all of them (bit for bit on the CPU; on the
        card cuBLAS may pick another algorithm for the smaller batched
        GEMM, and int8's roundings carry the last bit on). The text tower
        stays whole: it runs outside the quantised scope, and its
        row-parallel sums, rounded apart from the single process's, would
        move every activation scale taken downstream of the prompt."""
        int8 = self.quant != "none"
        if int8:
            params = self._quantized(params)
        heads = {"unet": self.cfg.unet.num_heads, "controlnet": self.cfg.unet.num_heads,
                 "clip": self.cfg.clip.num_heads, "vae": 1}
        local = {k: v if int8 and k == "clip" else shard_params_tp(mesh, v, heads.get(k))
                 for k, v in params.items()}
        with tp.model_parallel(mesh.get_group(MODEL_AXIS)):
            return self.generate_dp(mesh, local, prompt_ids, negative_prompt_ids, cond_images,
                                    **kwargs)

    # ------------------------------------------------------------ int8
    @torch.no_grad()
    def calibrate_int8(self, params, prompt_ids, negative_prompt_ids,
                       cond_images: Sequence[torch.Tensor],
                       generator: Optional[torch.Generator] = None, margin: float = 1.25,
                       timesteps: Sequence[int] = (999, 749, 499, 249, 1)) -> Dict[str, float]:
        """Record the per-layer activation scales of "int8-static".

        Runs the denoise model (ControlNets + UNet with CFG, the scope that
        int8 quantises) once at each of ``timesteps`` on unit-normal latents
        drawn from ``generator`` (seed 0 on this pipeline's device by
        default) with the given conditioning, collecting each keyed layer's
        dynamic absmax scale (ops/quant.py::recording, device scalars read
        once per timestep). The max over the timesteps times ``margin`` is
        the table, keyed like the JAX package's; beyond it the static
        quantiser clips. The latents follow the control images' size (JAX
        takes ``cfg.vae.sample_size``, the same size wherever both run)."""
        dev = self.device
        cfg = self.cfg
        prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
        negative_prompt_ids = torch.as_tensor(negative_prompt_ids, device=dev).long()
        cond_images = [torch.as_tensor(im).to(dev, torch.float32)
                       .contiguous(memory_format=torch.channels_last) for im in cond_images]
        b = prompt_ids.shape[0]
        h = cond_images[0].shape[2] // self.vae_downscale
        w = cond_images[0].shape[3] // self.vae_downscale
        context = self.encode_prompt(params, prompt_ids, negative_prompt_ids)
        embs = self.embed_cond_images(params, cond_images)
        embs2 = [torch.cat([e, e], dim=0) for e in embs]
        qp = self._quantized(params)
        scales = np.ones((cfg.num_branches,), np.float32)
        g = torch.ones((), dtype=torch.float32, device=dev)
        if generator is None:
            generator = make_generator(0, dev)
        table: Dict[str, float] = {}
        for t in timesteps:
            lat = torch.randn((b, cfg.unet.in_channels, h, w), generator=generator, device=dev,
                              dtype=torch.float32).contiguous(memory_format=torch.channels_last)
            rec: Dict[str, torch.Tensor] = {}
            with recording(rec), quantize_intercept(True):
                self._eval_step(True, qp, context, embs, embs2, scales, g, b, False, lat,
                                int(t))
            keys = list(rec)
            for k, v in zip(keys, torch.stack([rec[k] for k in keys]).tolist()):
                table[k] = max(table.get(k, 0.0), v)
        self._int8_scales = {k: v * margin for k, v in table.items()}
        return self._int8_scales

    def _quantized(self, params):
        """:func:`quantize_denoise_params` of ``params``, whose int8 UNet and
        ControlNet trees are kept for the next call while those leaves are
        the same tensors at the same version counters (a server's weights):
        a leaf swapped or written in place quantises them again. A tree
        that already holds int8 kernels (``generate_tp``'s slices of the
        quantised weights) is returned as it is."""
        leaves = list(flatten({"u": params["unet"], "c": params["controlnet"]}).values())
        if any(is_prequant(v) for v in leaves):
            return params
        versions = [_version(t) for t in leaves]
        held = self._int8_weights
        if (held is None or None in versions or held[1] != versions
                or any(a is not b for a, b in zip(held[0], leaves))):
            qp = quantize_denoise_params(params)
            held = (leaves, versions, {"unet": qp["unet"], "controlnet": qp["controlnet"]})
            self._int8_weights = held if None not in versions else None
        return {**params, **held[2]}

    def save_int8_scales(self, path: str) -> None:
        """Write the int8-static table as JSON (the JAX package's format), so
        a serving process skips the first-request calibration."""
        if self._int8_scales is None:
            raise RuntimeError("no calibration table to save: run calibrate_int8 (or one "
                               "int8-static generation) first")
        with open(path, "w") as f:
            json.dump(self._int8_scales, f, indent=0, sort_keys=True)

    def load_int8_scales(self, path: str) -> None:
        """Read a table that :meth:`save_int8_scales` (either package's)
        wrote."""
        with open(path) as f:
            table = json.load(f)
        if not table or not all(isinstance(k, str) and isinstance(v, (int, float)) and v > 0
                                for k, v in table.items()):
            raise ValueError(f"{path} is not an int8 scale table")
        self._int8_scales = {k: float(v) for k, v in table.items()}

    def _quant_scales_static(self) -> Dict[str, float]:
        if self._int8_scales is None:
            raise RuntimeError("int8-static needs a calibration table: call calibrate_int8 or "
                               "load_int8_scales first (__call__ calibrates on the first "
                               "request)")
        return self._int8_scales

    def _step_scales(self, num_steps: int, conditioning_scale, start, end) -> np.ndarray:
        """(num_steps, num_branches) host float32: the reference's keep mask
        (0 when i/N < start or (i+1)/N > end) times the per-branch scale."""
        n = self.cfg.num_branches
        starts = np.broadcast_to(np.asarray(start, np.float32), (n,))
        ends = np.broadcast_to(np.asarray(end, np.float32), (n,))
        i = np.arange(num_steps, dtype=np.float32)[:, None]
        keep = 1.0 - ((i / num_steps < starts[None, :])
                      | ((i + 1) / num_steps > ends[None, :])).astype(np.float32)
        scales = (np.ones((n,), np.float32) if conditioning_scale is None
                  else np.asarray(conditioning_scale, np.float32))
        return (keep * scales[None, :]).astype(np.float32)

    def _check_inputs(self, prompt_ids, negative_prompt_ids, cond_images,
                      num_inference_steps, latents):
        cfg = self.cfg
        if prompt_ids.shape != negative_prompt_ids.shape:
            raise ValueError(f"prompt ids {tuple(prompt_ids.shape)} vs negative "
                             f"{tuple(negative_prompt_ids.shape)}")
        if prompt_ids.ndim != 2 or prompt_ids.shape[1] != cfg.clip.max_positions:
            raise ValueError(f"prompt_ids must be (B, {cfg.clip.max_positions}), got "
                             f"{tuple(prompt_ids.shape)}")
        if len(cond_images) != cfg.num_branches:
            raise ValueError(f"expected {cfg.num_branches} control images, got "
                             f"{len(cond_images)}")
        b = prompt_ids.shape[0]
        for i, im in enumerate(cond_images):
            if im.ndim != 4 or im.shape[0] != b or im.shape[1] != 3:
                raise ValueError(f"cond image {i}: expected (B={b}, 3, H, W), got "
                                 f"{tuple(im.shape)}")
            if im.shape[2] % 8 or im.shape[3] % 8:
                raise ValueError(f"cond image {i}: H/W must be divisible by 8, got "
                                 f"{tuple(im.shape)}")
        if num_inference_steps < 1:
            raise ValueError("num_inference_steps must be >= 1")
        if latents is not None:
            want = (b, cfg.unet.in_channels, cond_images[0].shape[2] // self.vae_downscale,
                    cond_images[0].shape[3] // self.vae_downscale)
            if tuple(latents.shape) != want:
                raise ValueError(f"latents must be {want}, got {tuple(latents.shape)}")

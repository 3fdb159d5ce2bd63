"""LCM-LoRA distillation (consistency and CFG-guidance modes), and the
serving side's merge of the distilled adapters.

Counterpart of edgestyle_tpu/training/distill.py. The frozen try-on stack
(SD1.5 UNet + the six-branch MultiControlNet) teaches rank-64 adapters on
every attention, feed-forward and time-embedding linear of the whole UNet
(up blocks included), so the pipeline can serve at 2-8 steps with
``PipelineConfig(scheduler="lcm")`` and ``cfg_interval=(0.0, 0.0)``.

Two modes (:class:`DistillConfig`'s ``mode``):

* ``"consistency"`` (LCM-LoRA, arXiv:2311.05556): t_{n+k} from a
  ``num_ddim_timesteps``-point DDIM grid; z = add_noise(x0, eps, t_{n+k});
  w ~ U[w_min, w_max); the teacher (frozen UNet + MultiControlNet, one
  batched CFG pair of 2B rows, [uncond; cond]) takes one guided DDIM step
  to z_hat at t_n; the student f(z, t_{n+k}) = c_skip z + c_out x0_hat on
  the LoRA-merged UNet; the target is the same estimate at (z_hat, t_n) on
  the stop-gradient adapters (the EMA copy when ``ema_decay`` is set);
  pseudo-Huber (or L2) between the two.
* ``"guidance"`` (Meng et al., arXiv:2210.03142 stage 1): the conditional
  student regresses the teacher's guided eps at the same (z, t), w pinned
  (w_min == w_max); it serves at the same step count with CFG off.

As in training/train_step.py: the loss takes its random draws as arguments
(:func:`sample_distill_draws` makes them from a ``torch.Generator``), so a
test can give the port and the JAX package the same numbers; gradient
accumulation is a Python loop with fp32 accumulators; the state's ``step``
is a host int. Everything before the student (the VAE, CLIP, the cond
embeddings, the MultiControlNet), the teacher and the target run under
``torch.no_grad()``: only the student UNet, on the frozen UNet with the
adapters merged into its (compute-dtype) kernels, builds a graph, so the
gradients reach only the adapters. On the card every flash attention and
every ResNet conv runs through the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from edgestyle_tpu_torch.core.mesh import all_mean_grads
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.models.unet import LORA_LINEAR_LEAF_NAMES, merge_lora
from edgestyle_tpu_torch.schedulers.ddpm import DeviceSchedule, NoiseSchedule, add_noise
from edgestyle_tpu_torch.training.optim import AdamW, ClippedOptimizer, apply_updates
from edgestyle_tpu_torch.training.train_step import (
    SCHEDULE,
    _conv_in_apply,
    _encode,
    _swap_clothes,
)

MODES = ("consistency", "guidance")
LOSS_TYPES = ("huber", "l2")


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    lora_rank: int = 64  # LCM-LoRA uses 64 for SD1.5
    mode: str = "consistency"  # or "guidance"
    num_ddim_timesteps: int = 50  # the distillation grid (k = T / 50 = 20)
    w_min: float = 3.0  # the CFG range baked into the student
    w_max: float = 15.0
    loss_type: str = "huber"  # "huber" | "l2"
    huber_c: float = 0.001
    timestep_scaling: float = 10.0  # the boundary-condition scalings (LCM App. D)
    sigma_data: float = 0.5
    # None: the online student is its own target (the LCM-LoRA
    # simplification); a float (e.g. 0.95) keeps an EMA copy as full LCM
    ema_decay: Optional[float] = None
    learning_rate: float = 1e-4
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    swap_prob: float = 0.5  # the ControlLoRA trainer's data semantics
    use_agnostic: bool = False


# ----------------------------------------------------------------- LoRA set
def is_unet_lora_linear_path(path) -> bool:
    """The LCM-LoRA targets: the attention, feed-forward and time-embedding
    linears of the whole UNet (down, mid and up blocks and the time
    embedding), where the ControlLoRA adapters (models/unet.py
    ``is_lora_linear_path``) stop at the tied trunk."""
    if not path or path[-1] != "kernel":
        return False
    top = path[0]
    if not (top.startswith("down_blocks_") or top.startswith("up_blocks_")
            or top in ("mid_block", "time_embedding")):
        return False
    return any(path[-2] == n or path[-2].startswith(n) for n in LORA_LINEAR_LEAF_NAMES)


def init_unet_lora_params(gen: torch.Generator, unet_params: Dict, rank: int) -> Dict:
    """{path: {'down', 'up'}} adapters over the whole UNet, fp32 on the
    generator's device, in the port's layout: down (rank, in) ~ N(0, 1) /
    rank, up (out, rank) = 0 (diffusers' LoRALinearLayer init), so a fresh
    set leaves the UNet's output unchanged."""
    lora = {}
    for path, leaf in flatten(unet_params).items():
        if is_unet_lora_linear_path(path) and leaf.ndim == 2:
            dout, din = leaf.shape
            lora[path] = {
                "down": torch.randn((rank, din), generator=gen, device=gen.device) / rank,
                "up": torch.zeros((dout, rank), device=gen.device),
            }
    return unflatten(lora)


def apply_lcm_lora(unet_params: Dict, lcm_lora: Dict, scale: float = 1.0) -> Dict:
    """UNet params with the adapters ({path: {'down', 'up'}}, the port's
    layout, as ``training/checkpoint.py::import_safetensors`` gives them)
    merged: kernel <- kernel + scale * (up o down), as a new tree."""
    return merge_lora(unet_params, lcm_lora, scale)


# ----------------------------------------------------------------- math
def _x0_eps(sched: DeviceSchedule, sample: torch.Tensor, model_output: torch.Tensor,
            t: torch.Tensor):
    """(x0_hat, eps_hat), fp32, from a raw model output at per-sample
    timesteps ``t``."""
    ac = sched.alphas_cumprod[t].reshape(-1, *([1] * (sample.ndim - 1)))
    a, s = torch.sqrt(ac), torch.sqrt(1.0 - ac)
    sample, model_output = sample.float(), model_output.float()
    if sched.prediction_type == "epsilon":
        return (sample - s * model_output) / a, model_output
    # v_prediction
    return a * sample - s * model_output, a * model_output + s * sample


def _boundary_scalings(cfg: DistillConfig, t: torch.Tensor, ndim: int):
    """c_skip and c_out at per-sample timesteps, fp32: LCM's discrete
    boundary conditions (c_skip -> 1, c_out -> 0 as t -> 0, so f(x, 0) =
    x)."""
    st = t.float() * cfg.timestep_scaling
    sd2 = cfg.sigma_data ** 2
    shape = (-1, *([1] * (ndim - 1)))
    c_skip = sd2 / (st.square() + sd2)
    c_out = st / torch.sqrt(st.square() + sd2)
    return c_skip.reshape(shape), c_out.reshape(shape)


def sample_distill_draws(pipe, cfg: DistillConfig, batch: Dict[str, torch.Tensor],
                         gen: torch.Generator) -> List[Dict]:
    """One dict of random draws per micro-batch, from ``gen`` (on its
    device): the VAE posterior noise of the original and of the three VAE
    conds, the diffusion noise, ``idx`` (the DDIM grid index in consistency
    mode, the timestep in [0, T) in guidance mode), w ~ U[w_min, w_max) of
    shape (b, 1, 1, 1) and the swap flips."""
    ga, b, _, h, w = batch["original"].shape
    lat = (b, pipe.cfg.vae.latent_channels, h // pipe.vae_downscale, w // pipe.vae_downscale)
    hi = cfg.num_ddim_timesteps if cfg.mode == "consistency" else SCHEDULE.num_train_timesteps
    dev = gen.device
    out = []
    for _ in range(ga):
        out.append({
            "vae_eps": torch.randn(lat, generator=gen, device=dev),
            "cond_eps": torch.randn((3 * b, *lat[1:]), generator=gen, device=dev),
            "noise": torch.randn(lat, generator=gen, device=dev),
            "idx": torch.randint(0, hi, (b,), generator=gen, device=dev),
            "w": cfg.w_min + (cfg.w_max - cfg.w_min) * torch.rand(
                (b, 1, 1, 1), generator=gen, device=dev),
            "flip": torch.rand((b,), generator=gen, device=dev) < cfg.swap_prob,
        })
    return out


# ----------------------------------------------------------------- loss
def distill_loss_fn(lcm_lora: Dict, target_lora: Optional[Dict], frozen: Dict, pipe,
                    sched: DeviceSchedule, cfg: DistillConfig, batch: Dict[str, torch.Tensor],
                    uncond_ctx: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One distillation loss evaluation, a 0-d fp32 tensor.

    ``frozen``: {vae, clip, unet, static, controlnet}, the trainer's frozen
    set plus the trained ControlNet branch set under 'controlnet' (as the
    pipeline consumes it); ``uncond_ctx``: the pre-encoded empty prompt's
    context (1, n, C); ``target_lora``: the EMA adapters, or None for the
    online ones (consistency mode; read without gradient)."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown distill mode {cfg.mode!r}")
    if cfg.loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
    sf = pipe.cfg.vae.scaling_factor
    with torch.no_grad():
        batch = _swap_clothes(batch, draws["flip"])
        latents = _encode(pipe, frozen["vae"], batch["original"], draws["vae_eps"]) * sf
        ctx = pipe.clip(frozen["clip"], batch["input_ids"])["last_hidden_state"]
        b = latents.shape[0]
        uctx = uncond_ctx.expand(b, *uncond_ctx.shape[1:]).to(ctx.dtype)
        if cfg.mode == "guidance":
            # dense uniform timesteps: no bootstrap chain
            start_t = draws["idx"]
        else:
            # the DDIM grid: t_{n+k} (start) and t_n (target)
            k = sched.num_train_timesteps // cfg.num_ddim_timesteps
            grid = torch.arange(1, cfg.num_ddim_timesteps + 1, device=latents.device) * k - 1
            start_t = grid[draws["idx"]]
            prev_t = (start_t - k).clamp(min=0)
        noisy = add_noise(sched, latents.float(), draws["noise"].float(), start_t)
        w = draws["w"]

        # the conditioning embeddings (the trainer's six-branch layout)
        first = batch["agnostic"] if cfg.use_agnostic else batch["head"]
        vae_conds = torch.cat([first, batch["clothes"], batch["clothes2"]], dim=0)
        lat_c = _encode(pipe, frozen["vae"], vae_conds, draws["cond_eps"]) * sf
        e0, e2, e4 = _conv_in_apply(frozen["unet"]["conv_in"], lat_c).split(b)
        conv_conds = torch.cat([batch["original_openpose"], batch["clothes_openpose"],
                                batch["clothes_openpose2"]], dim=0)
        e1, e3, e5 = pipe.mcn.branch.embed_cond(frozen["static"], conv_conds).split(b)
        embs = [e0, e1, e2, e3, e4, e5]
        cn = frozen["controlnet"]

        # the teacher: one batched CFG pair at the start point, [uncond; cond]
        z2 = torch.cat([noisy, noisy], dim=0)
        t2 = torch.cat([start_t, start_t], dim=0)
        ctx2 = torch.cat([uctx, ctx], dim=0)
        down2, mid2 = pipe.mcn(cn, z2, t2, ctx2, [torch.cat([e, e], dim=0) for e in embs])
        pred_t2 = pipe.unet(frozen["unet"], z2, t2, ctx2, down_block_additional_residuals=down2,
                            mid_block_additional_residual=mid2)
        x0_t2, eps_t2 = _x0_eps(sched, z2, pred_t2, t2)
        x0_u, x0_c = x0_t2.split(b)
        eps_u, eps_c = eps_t2.split(b)
        down_c, mid_c = tuple(d[b:] for d in down2), mid2[b:]
        if cfg.mode == "guidance":
            eps_cfg = eps_c + w * (eps_c - eps_u)
        else:
            x0_cfg = x0_c + w * (x0_c - x0_u)
            eps_cfg = eps_c + w * (eps_c - eps_u)
            # one DDIM step along the guided teacher trajectory
            ac_prev = sched.alphas_cumprod[prev_t].reshape(-1, 1, 1, 1)
            x_prev = torch.sqrt(ac_prev) * x0_cfg + torch.sqrt(1.0 - ac_prev) * eps_cfg
            # the target: the consistency estimate at the stepped point
            tgt = lcm_lora if target_lora is None else target_lora
            tgt = unflatten({k_: v.detach() for k_, v in flatten(tgt).items()})
            down_p, mid_p = pipe.mcn(cn, x_prev, prev_t, ctx, embs)
            pred_p = pipe.unet(merge_lora(frozen["unet"], tgt), x_prev, prev_t, ctx,
                               down_block_additional_residuals=down_p,
                               mid_block_additional_residual=mid_p)
            x0_p, _ = _x0_eps(sched, x_prev, pred_p, prev_t)
            cs_p, co_p = _boundary_scalings(cfg, prev_t, noisy.ndim)
            f_target = cs_p * x_prev + co_p * x0_p

    # the student: the LoRA-merged UNet at the conditional start point
    pred_s = pipe.unet(merge_lora(frozen["unet"], lcm_lora), noisy, start_t, ctx,
                       down_block_additional_residuals=down_c, mid_block_additional_residual=mid_c)
    x0_s, eps_s = _x0_eps(sched, noisy, pred_s, start_t)
    if cfg.mode == "guidance":
        # eps space keeps the loss well-conditioned at large t
        diff = eps_s - eps_cfg
    else:
        cs_s, co_s = _boundary_scalings(cfg, start_t, noisy.ndim)
        diff = cs_s * noisy + co_s * x0_s - f_target
    if cfg.loss_type == "huber":
        # pseudo-Huber sqrt(d^2 + c^2) - c, the LCM-LoRA recipe's default
        return (torch.sqrt(diff.square() + cfg.huber_c ** 2) - cfg.huber_c).mean()
    return diff.square().mean()


# ----------------------------------------------------------------- step
def make_distill_optimizer(cfg: DistillConfig) -> ClippedOptimizer:
    return ClippedOptimizer(AdamW(cfg.learning_rate, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                                  eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay),
                            cfg.max_grad_norm)


def init_distill_state(pipe, gen: torch.Generator, unet_params: Dict,
                       cfg: DistillConfig) -> Dict:
    """{lcm_lora, opt_state, step} (+ ``target``, a copy of the adapters,
    when ``ema_decay`` is set)."""
    lora = init_unet_lora_params(gen, unet_params, cfg.lora_rank)
    state = {"lcm_lora": lora, "opt_state": make_distill_optimizer(cfg).init(lora), "step": 0}
    if cfg.ema_decay is not None:
        state["target"] = unflatten({k: v.clone() for k, v in flatten(lora).items()})
    return state


def make_distill_step(pipe, cfg: DistillConfig, sched: Optional[NoiseSchedule] = None,
                      data_group=None):
    """Returns ``distill_step(state, frozen, batch, uncond_ctx, draws) ->
    (state, metrics)``: batches of (grad_accum, micro_bs, ...) tensors,
    ``draws`` :func:`sample_distill_draws`' list; metrics {'loss': the mean
    micro-batch loss}, a 0-d device tensor. The EMA target follows the
    optimizer's update: d * target + (1 - d) * online. ``data_group``: data
    parallel, as training/train_step.py::make_train_step takes it (each
    rank's rows of the batch and of the draws, train_step.local_draws;
    gradients and losses averaged over the group before the optimizer)."""
    if cfg.mode == "guidance" and cfg.w_min != cfg.w_max:
        # the guidance student has no w input: a random w would give the
        # same (z, t, cond) a different regression target at every draw
        raise ValueError("mode='guidance' needs a pinned CFG scale (w_min == w_max); "
                         f"got w_min={cfg.w_min}, w_max={cfg.w_max}")
    dsched = (sched or SCHEDULE).to(pipe.device)
    opt = make_distill_optimizer(cfg)

    def grads_of(lora, target, frozen, mb, uncond_ctx, dr):
        leaves = {k: v.detach().requires_grad_(True) for k, v in flatten(lora).items()}
        loss = distill_loss_fn(unflatten(leaves), target, frozen, pipe, dsched, cfg, mb,
                               uncond_ctx, dr)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: g.float() for k, g in zip(leaves, grads)}

    def distill_step(state, frozen, batch, uncond_ctx, draws):
        lora, target = state["lcm_lora"], state.get("target")
        if cfg.grad_accum == 1:
            loss, grads = grads_of(lora, target, frozen, {k: v[0] for k, v in batch.items()},
                                   uncond_ctx, draws[0])
            losses = [loss]
        else:
            grads = {k: torch.zeros_like(v, dtype=torch.float32)
                     for k, v in flatten(lora).items()}
            losses = []
            for i in range(cfg.grad_accum):
                loss, g = grads_of(lora, target, frozen, {k: v[i] for k, v in batch.items()},
                                   uncond_ctx, draws[i])
                grads = {k: a + g[k] / cfg.grad_accum for k, a in grads.items()}
                losses.append(loss)
        if data_group is not None:
            grads, losses = all_mean_grads(grads, losses, data_group)
        updates, opt_state = opt.update(unflatten(grads), state["opt_state"], lora)
        new_lora = apply_updates(lora, updates)
        new_state = {"lcm_lora": new_lora, "opt_state": opt_state, "step": state["step"] + 1}
        if target is not None:
            d = cfg.ema_decay
            online = flatten(new_lora)
            new_state["target"] = unflatten({k: d * tg + (1.0 - d) * online[k]
                                             for k, tg in flatten(target).items()})
        return new_state, {"loss": torch.stack(losses).mean()}

    return distill_step

"""The ControlLoRA finetune step.

Counterpart of edgestyle_tpu/training/train_step.py: VAE encode and CLIP
encode -> noise, uniform timesteps and ``add_noise`` -> the per-sample
clothes <-> clothes2 swap -> the 6-branch MultiControlNet (tied LoRA trunks)
-> the UNet's noise prediction -> MSE with Min-SNR-gamma -> global-norm
clipping -> Prodigy (or AdamW).

* The trainables are {lora_0, lora_1, heads_0, heads_1, fusion}, fp32; the
  frozen weights {vae, clip, unet, static} are in the compute dtype. The
  ControlLoRA branch trees are assembled inside the loss (tied trunk +
  merged LoRA), so gradients reach only the adapters.
* The loss takes its random draws as arguments (:func:`sample_draws` makes
  them from a ``torch.Generator``), so a test can give the port and the JAX
  package the same numbers.
* Gradient accumulation is a Python loop over the micro-batches with fp32
  accumulators, each micro-batch's grads divided by ``grad_accum``;
  ``grad_accum == 1`` takes one grad with no accumulator. ``remat`` wraps
  the per-micro-batch loss in ``torch.utils.checkpoint`` (non-reentrant):
  activations are recomputed in the backward instead of kept.
* On the card every flash attention and every ResNet conv runs through the
  kernels' autograd Functions (ops/flash.py, ops/fused_conv.py).
* Data parallel over several ranks (``make_train_step``'s ``data_group``):
  each rank takes its rows of every micro-batch and of the global draws,
  and one all-reduce averages the gradients and losses before the
  optimizer, as the JAX step's batch sharding does through GSPMD.
* DP x TP (``model_group`` in place of ``data_group``): the frozen set is each rank's slices
  (core/partitioning.py::shard_pipeline_frozen_tp), the trainables whole;
  the loss runs inside ``ops.tp.model_parallel``, where the LoRA merge
  slices each adapter's delta like its kernel and sums those adapters'
  gradients over the model group (models/unet.py::merge_lora), and the
  average runs over every rank. A rank's rows follow its data coordinate.

The state is a dict {trainable, opt_state, step}; ``step`` is a host int.
Batches are dicts of (grad_accum, micro_bs, ...) tensors, images NCHW.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.mesh import all_mean_grads
from edgestyle_tpu_torch.core.params import InitTree, flatten, materialize, unflatten
from edgestyle_tpu_torch.models.multicontrolnet import edgestyle_fusion
from edgestyle_tpu_torch.models.unet import (
    controllora_params,
    init_lora_params,
    split_trunk_params,
)
from edgestyle_tpu_torch.ops import tp
from edgestyle_tpu_torch.schedulers.ddpm import (
    DeviceSchedule,
    NoiseSchedule,
    add_noise,
    training_target,
)
from edgestyle_tpu_torch.training.minsnr import min_snr_weights, weighted_mse
from edgestyle_tpu_torch.training.optim import AdamW, ClippedOptimizer, apply_updates
from edgestyle_tpu_torch.training.prodigy import Prodigy, get_d
from edgestyle_tpu_torch.training.schedules import build_lr_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    snr_gamma: Optional[float] = 5.0
    max_grad_norm: float = 1.0
    remat: bool = False
    optimizer: str = "prodigy"  # "prodigy" | "adamw"
    learning_rate: float = 1.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    # diffusers get_scheduler names (+ the alias cosine_annealing);
    # "constant" when lr_total_steps is unset
    lr_scheduler: str = "cosine"
    lr_total_steps: Optional[int] = None
    lr_warmup_steps: int = 0
    lr_num_cycles: float = 1.0
    lr_power: float = 1.0
    prodigy_beta3: Optional[float] = None
    prodigy_decouple: bool = True
    prodigy_use_bias_correction: bool = True
    prodigy_safeguard_warmup: bool = True
    weight_decay: float = 1e-4
    swap_prob: float = 0.5
    use_agnostic: bool = False  # reference default: head crops
    grad_accum: int = 1


# batch schema (the reference collate's output), images (B, 3, H, W)
BATCH_KEYS = (
    "original",            # in [-1, 1]
    "agnostic",            # VAE-branch conds in [-1, 1]
    "head",                # used instead of agnostic when use_agnostic=False
    "clothes",
    "clothes2",
    "original_openpose",   # conv-branch conds in [0, 1]
    "clothes_openpose",
    "clothes_openpose2",
    "input_ids",           # (B, 77) int
)
TRAINABLE_GROUPS = ("lora_0", "lora_1", "heads_0", "heads_1", "fusion")
SCHEDULE = NoiseSchedule.sd15()


def make_optimizer(cfg: TrainConfig) -> ClippedOptimizer:
    if cfg.lr_total_steps or cfg.lr_warmup_steps:
        sched = build_lr_schedule(
            cfg.lr_scheduler if cfg.lr_total_steps else "constant_with_warmup",
            cfg.learning_rate, cfg.lr_warmup_steps, cfg.lr_total_steps,
            cfg.lr_num_cycles, cfg.lr_power,
        )
    else:
        sched = cfg.learning_rate
    if cfg.optimizer == "adamw":
        inner = AdamW(sched, b1=cfg.adam_beta1, b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
                      weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "prodigy":
        inner = Prodigy(
            learning_rate=sched, betas=(cfg.adam_beta1, cfg.adam_beta2),
            beta3=cfg.prodigy_beta3, eps=cfg.adam_epsilon, weight_decay=cfg.weight_decay,
            decouple=cfg.prodigy_decouple, use_bias_correction=cfg.prodigy_use_bias_correction,
            safeguard_warmup=cfg.prodigy_safeguard_warmup,
        )
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return ClippedOptimizer(inner, cfg.max_grad_norm)


def init_trainable(pipe, gen: torch.Generator, unet_params: Dict, lora_rank: int = 32,
                   lora_conv_rank: int = 0) -> Dict:
    """A fresh trainable set, fp32 on the generator's device: two LoRA
    adapters on the UNet's trunk, their zero-conv heads (zeros, the second a
    copy of the first) and the fusion blocks at the pipeline's latent size.
    ``lora_conv_rank`` > 0 adapts every trunk conv too."""
    cfg = pipe.cfg
    meta = torch.device("meta")
    hw = cfg.vae.sample_size // pipe.vae_downscale
    lat = torch.zeros((1, cfg.unet.in_channels, hw, hw), device=meta)
    t = torch.zeros((1,), dtype=torch.long, device=meta)
    ctx = torch.zeros((1, cfg.clip.max_positions, cfg.clip.hidden_size), device=meta)
    emb = torch.zeros((1, cfg.unet.block_out_channels[0], hw, hw), device=meta)
    branch, fusion = InitTree(), InitTree()
    down, mid = pipe.mcn.branch.controlnet_forward(branch, lat, t, ctx, emb)
    n = cfg.num_branches
    edgestyle_fusion(fusion, [list(down)] * n, [mid] * n, pipe.mcn.down_channels,
                     cfg.unet.block_out_channels[-1], torch.float32)
    heads = InitTree()  # the branch's zero-conv heads only, not its trunk
    heads.update({k: v for k, v in branch.items() if k.startswith("controlnet_")})
    trunk = split_trunk_params(unet_params)
    lora_0 = init_lora_params(gen, trunk, lora_rank, lora_conv_rank)
    lora_1 = init_lora_params(gen, trunk, lora_rank, lora_conv_rank)
    heads = materialize(heads, gen, torch.float32)
    return {
        "lora_0": lora_0,
        "lora_1": lora_1,
        "heads_0": heads,
        "heads_1": unflatten({k: v.clone() for k, v in flatten(heads).items()}),
        "fusion": materialize(fusion, gen, torch.float32),
    }


def sample_draws(pipe, cfg: TrainConfig, batch: Dict[str, torch.Tensor],
                 gen: torch.Generator) -> List[Dict]:
    """One dict of random draws per micro-batch, from ``gen`` (on its
    device): the VAE posterior noise of the original and of the three VAE
    conds, the diffusion noise, the timesteps and the swap flips."""
    ga, b, _, h, w = batch["original"].shape
    lat = (b, pipe.cfg.vae.latent_channels, h // pipe.vae_downscale, w // pipe.vae_downscale)
    dev = gen.device
    out = []
    for _ in range(ga):
        out.append({
            "vae_eps": torch.randn(lat, generator=gen, device=dev),
            "cond_eps": torch.randn((3 * b, *lat[1:]), generator=gen, device=dev),
            "noise": torch.randn(lat, generator=gen, device=dev),
            "timesteps": torch.randint(0, SCHEDULE.num_train_timesteps, (b,), generator=gen,
                                       device=dev),
            "flip": torch.rand((b,), generator=gen, device=dev) < cfg.swap_prob,
        })
    return out


def _swap_clothes(batch: Dict, flip: torch.Tensor) -> Dict:
    """Per-sample clothes <-> clothes2 (and their openpose maps) where
    ``flip``, branch-free."""
    f = flip.reshape(-1, 1, 1, 1)

    def sw(a, b):
        return torch.where(f, b, a), torch.where(f, a, b)

    c, c2 = sw(batch["clothes"], batch["clothes2"])
    o, o2 = sw(batch["clothes_openpose"], batch["clothes_openpose2"])
    return {**batch, "clothes": c, "clothes2": c2, "clothes_openpose": o,
            "clothes_openpose2": o2}


def _encode(pipe, vae_params, x, eps):
    """VAE posterior sample mean + std * eps (unscaled)."""
    mean, logvar = pipe.vae.encode_moments(vae_params, x)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def _conv_in_apply(conv_params, x):
    """The UNet's conv_in (3x3, pad 1) in its weights' dtype."""
    k = conv_params["kernel"]
    return F.conv2d(x.to(k.dtype), k, conv_params["bias"].to(k.dtype), padding=1)


def controlnet_loss_fn(trainable: Dict, frozen: Dict, pipe, sched: DeviceSchedule,
                       cfg: TrainConfig, batch: Dict[str, torch.Tensor],
                       draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The Min-SNR-weighted (or plain) MSE of one micro-batch, a 0-d fp32
    tensor."""
    sf = pipe.cfg.vae.scaling_factor
    batch = _swap_clothes(batch, draws["flip"])
    latents = _encode(pipe, frozen["vae"], batch["original"], draws["vae_eps"]) * sf
    ctx = pipe.clip(frozen["clip"], batch["input_ids"])["last_hidden_state"]

    b = latents.shape[0]
    noise = draws["noise"].to(latents.dtype)
    t = draws["timesteps"]
    noisy = add_noise(sched, latents, noise, t)

    first = batch["agnostic"] if cfg.use_agnostic else batch["head"]
    vae_conds = torch.cat([first, batch["clothes"], batch["clothes2"]], dim=0)
    lat_c = _encode(pipe, frozen["vae"], vae_conds, draws["cond_eps"]) * sf
    e0, e2, e4 = _conv_in_apply(frozen["unet"]["conv_in"], lat_c).split(b)
    conv_conds = torch.cat([batch["original_openpose"], batch["clothes_openpose"],
                            batch["clothes_openpose2"]], dim=0)
    e1, e3, e5 = pipe.mcn.branch.embed_cond(frozen["static"], conv_conds).split(b)

    with spans.span(spans.TRAIN_MERGE_LORA):
        cn_params = {
            "static": frozen["static"],
            "lora_0": controllora_params(frozen["unet"], trainable["lora_0"],
                                         trainable["heads_0"]),
            "lora_1": controllora_params(frozen["unet"], trainable["lora_1"],
                                         trainable["heads_1"]),
            "fusion": trainable["fusion"],
        }
    down, mid = pipe.mcn(cn_params, noisy, t, ctx, [e0, e1, e2, e3, e4, e5])
    pred = pipe.unet(frozen["unet"], noisy, t, ctx, down_block_additional_residuals=down,
                     mid_block_additional_residual=mid)
    target = training_target(sched, latents, noise, t)
    if cfg.snr_gamma is None:
        return (pred.float() - target.float()).square().mean()
    return weighted_mse(pred, target, min_snr_weights(sched, t, cfg.snr_gamma))


def local_draws(draws: List[Dict], sl: slice, b: int) -> List[Dict]:
    """This rank's rows ``sl`` of the draws of a global micro-batch of ``b``
    rows (:func:`sample_draws`, training/distill.py's too): every draw is
    (b, ...) but ``cond_eps``, which stacks the three VAE conds' (b, ...)
    blocks, so each third gives its rows."""
    def take(k, v):
        return torch.cat([blk[sl] for blk in v.split(b)]) if k == "cond_eps" else v[sl]

    return [{k: take(k, v) for k, v in d.items()} for d in draws]


def make_train_step(pipe, cfg: TrainConfig, data_group=None, model_group=None):
    """Returns ``train_step(state, frozen, batch, draws) -> (state,
    metrics)``; ``draws`` is :func:`sample_draws`' list, one per
    micro-batch. metrics: {'loss': mean micro-batch loss, 'd': Prodigy's d
    (the learning rate for AdamW)}, 0-d device tensors.

    With ``data_group`` (data parallel, core/mesh.py) each rank passes its
    rows of every micro-batch and of the draws (:func:`local_draws`); the
    gradients and the losses are averaged over the group in one
    all-reduce before the clipping, so the clipping and Prodigy's d see
    the global gradient, and the state stays the same on every rank.

    With ``model_group`` in its place (DP x TP; passing both raises),
    ``frozen`` holds this rank's tensor-parallel slices
    (core/partitioning.py::shard_pipeline_frozen_tp) and each micro-batch's
    loss runs inside ``ops.tp.model_parallel`` (the recomputation of
    ``remat`` too): each rank of a model group gets the same loss and the
    whole gradient of every trainable. The one all-reduce then averages
    over every rank of the mesh (the default group: core/mesh.py::make_mesh
    spans them all), the data axis's mean with the model group's copies
    folded in: the copies are equal in exact arithmetic, but each process's
    convolutions and GEMMs may take other library algorithms and round
    apart, and the whole mesh's sum gives every rank the same bits, so the
    trainables stay one state."""
    if data_group is not None and model_group is not None:
        raise ValueError("make_train_step: under a model_group the step averages over every "
                         "rank of the mesh; pass no data_group")
    dsched = SCHEDULE.to(pipe.device)
    opt = make_optimizer(cfg)

    def loss_fn(trainable, frozen, mb, dr):
        with tp.model_parallel(model_group) if model_group is not None else nullcontext():
            return controlnet_loss_fn(trainable, frozen, pipe, dsched, cfg, mb, dr)

    def grads_of(trainable, frozen, mb, dr):
        leaves = {k: v.detach().requires_grad_(True) for k, v in flatten(trainable).items()}
        tree = unflatten(leaves)
        if cfg.remat:
            loss = torch.utils.checkpoint.checkpoint(loss_fn, tree, frozen, mb, dr,
                                                     use_reentrant=False)
        else:
            loss = loss_fn(tree, frozen, mb, dr)
        with spans.span(spans.TRAIN_BACKWARD):
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: g.float() for k, g in zip(leaves, grads)}

    def train_step(state, frozen, batch, draws):
        with spans.span(spans.TRAIN_STEP):
            trainable = state["trainable"]
            if cfg.grad_accum == 1:
                loss, grads = grads_of(trainable, frozen, {k: v[0] for k, v in batch.items()},
                                       draws[0])
                losses = [loss]
            else:
                grads = {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in flatten(trainable).items()}
                losses = []
                for i in range(cfg.grad_accum):
                    loss, g = grads_of(trainable, frozen, {k: v[i] for k, v in batch.items()},
                                       draws[i])
                    with spans.span(spans.TRAIN_ACCUMULATE):
                        grads = {k: a + g[k] / cfg.grad_accum for k, a in grads.items()}
                    losses.append(loss)
            if model_group is not None:
                grads, losses = all_mean_grads(grads, losses, None)
            elif data_group is not None:
                grads, losses = all_mean_grads(grads, losses, data_group)
            with spans.span(spans.TRAIN_OPTIMIZER):
                updates, opt_state = opt.update(unflatten(grads), state["opt_state"], trainable)
                new_trainable = apply_updates(trainable, updates)
            new_state = {"trainable": new_trainable, "opt_state": opt_state,
                         "step": state["step"] + 1}
            if cfg.optimizer == "prodigy":
                d = get_d(opt_state)
            else:
                d = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=pipe.device)
            return new_state, {"loss": torch.stack(losses).mean(), "d": d}

    return train_step

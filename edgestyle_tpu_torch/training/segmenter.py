"""SAM mask-decoder finetuning: the reference's four segmenter trainers
(segmenter_training_{subject,head,clothes,body}.py) as one step, set by the
head's label subset.

Counterpart of edgestyle_tpu/training/segmenter.py, with its semantics:

  * the image encoder and the prompt encoder are frozen and only the mask
    decoder trains (segmenter_training_subject.py:145-147). The encoder's
    forward and the prompt encoding run under ``torch.no_grad()`` (JAX's
    ``stop_gradient``), so no autograd graph is kept for either;
  * the box prompt is the target mask's bounding box with uniform integer
    noise in [-jitter, jitter] on each coordinate, clipped to the image
    (getBox :167-182, margin 0);
  * the binary target is the membership of the parsing label in the head's
    ``KEEP_CATEGORIES``, smoothed by ``smooth_mask(target, 3, 1)``
    (apply_conditions :230-243);
  * the loss is soft Dice plus BCE on the logits, each averaged over a
    sample's pixels, then over the batch (monai's DiceCELoss, :126-130);
  * Prodigy at lr 1.0, no weight decay (:385-394).

Everything runs in fp32, as JAX's ``EfficientViTSam`` does by default. The
box noise is an input of the step (:func:`draw_box_noise` draws it from a
``torch.Generator``), so a test can give the port the noise JAX drew. The
port's ``mask_bbox`` is batched and gives zeros for an empty mask (a head
whose categories are absent from the photo); such a box is jittered and
clipped as JAX does it, and the example still trains.

The state is a dict {decoder, opt_state, step}; ``step`` is a host int.
Batches are {'image': (B, 3, S, S) SAM-normalised, 'labels': (B, S, S)
int}.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.models.efficientvit.sam import (
    EfficientViTSam,
    dense_pe,
    mask_decoder,
    postprocess_masks,
    prompt_encoder,
)
from edgestyle_tpu_torch.ops.morphology import mask_bbox, smooth_mask
from edgestyle_tpu_torch.training.optim import apply_updates
from edgestyle_tpu_torch.training.prodigy import Prodigy

# mattmdjaga/human_parsing_dataset label subsets (the reference scripts' KEEP_CATEGORIES)
KEEP_CATEGORIES = {
    "subject": tuple(range(1, 18)),
    "head": (1, 2, 3, 11),
    "clothes": (4, 5, 6, 7, 8, 17),
    "body": (1, 2, 3, 9, 10, 11, 12, 13, 14, 15, 17),
}


@dataclasses.dataclass(frozen=True)
class SegmenterTrainConfig:
    head: str = "subject"
    learning_rate: float = 1.0
    box_jitter: int = 30
    smooth_target: bool = True


def binary_target(parsing_labels: torch.Tensor, head: str) -> torch.Tensor:
    """(B, H, W) int parsing map -> (B, H, W) bool membership mask."""
    cats = torch.tensor(KEEP_CATEGORIES[head], device=parsing_labels.device)
    return (parsing_labels[..., None] == cats).any(dim=-1)


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Soft Dice + BCE on sigmoid probabilities (monai DiceCELoss with
    sigmoid=True), mean over the batch."""
    x = logits.float()
    p = torch.sigmoid(x)
    t = target.float()
    axes = tuple(range(1, p.ndim))
    inter = (p * t).sum(axes)
    dice = 1.0 - (2 * inter + eps) / (p.sum(axes) + t.sum(axes) + eps)
    bce = F.binary_cross_entropy_with_logits(x, t, reduction="none").mean(axes)
    return (dice + bce).mean()


def draw_box_noise(generator: torch.Generator, batch: int, jitter: int) -> torch.Tensor:
    """(B, 4) int64 box noise, uniform in [-jitter, jitter], on the
    generator's device."""
    return torch.randint(-jitter, jitter + 1, (batch, 4), generator=generator,
                         device=generator.device)


def jittered_box(mask: torch.Tensor, noise: torch.Tensor,
                 prompt_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) target masks and (B, 4) noise -> box prompt points (B, 2,
    2) in the prompt frame and labels (B, 2) = (2, 3): the bounding box
    (margin 0) plus the noise, clipped to [0, W] x [0, H]."""
    b, h, w = mask.shape
    box = mask_bbox(mask, margin=0).float() + noise.float()
    hi = torch.tensor([w, h, w, h], dtype=torch.float32, device=mask.device)
    box = torch.minimum(torch.clamp(box, min=0.0), hi) * prompt_scale
    pts = torch.stack([box[:, :2], box[:, 2:]], dim=1)
    lbl = torch.tensor([2, 3], device=mask.device).expand(b, 2)
    return pts, lbl


def segmenter_loss(sam: EfficientViTSam, cfg: SegmenterTrainConfig, decoder: Dict, frozen: Dict,
                   batch: Dict, noise: torch.Tensor) -> torch.Tensor:
    """The DiceCE loss of ``decoder`` on ``batch`` with box noise ``noise``
    (B, 4); the gradient reaches the decoder's leaves only."""
    image, labels = batch["image"], batch["labels"]
    h, w = image.shape[2:]
    target = binary_target(labels, cfg.head)
    if cfg.smooth_target:
        target = smooth_mask(target, 3, 1)
    with torch.no_grad():  # the frozen encoders: no graph is kept
        emb = sam.encode_image(frozen, image.float())
        pe_p = frozen["prompt_encoder"]
        pts, lbl = jittered_box(target, noise, sam.cfg.prompt_input_size / sam.cfg.image_size)
        sparse, dense = prompt_encoder(pe_p, pts, lbl, sam.cfg.prompt_input_size)
        image_pe = dense_pe(pe_p, emb.device)
    masks, _ = mask_decoder(decoder, emb, image_pe, sparse, dense, multimask_output=False,
                            norm_eps=sam.cfg.norm_eps)
    logits = postprocess_masks(masks.float(), (h, w))[:, 0]
    return dice_ce_loss(logits, target)


def segmenter_grads(sam: EfficientViTSam, cfg: SegmenterTrainConfig, decoder: Dict, frozen: Dict,
                    batch: Dict, noise: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients of every decoder leaf as a tree like ``decoder``).
    The IoU head does not reach the loss: its gradients are zeros, as JAX's
    are."""
    leaves = flatten(decoder)
    live = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    with torch.enable_grad():
        loss = segmenter_loss(sam, cfg, unflatten(live), frozen, batch, noise)
        grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), unflatten({k: torch.zeros_like(v) if g is None else g
                                     for (k, v), g in zip(live.items(), grads)})


def make_segmenter_train_step(sam: EfficientViTSam, cfg: SegmenterTrainConfig) -> Callable:
    """Returns ``train_step(state, frozen, batch, noise) -> (state,
    metrics)``. ``frozen``: the full SAM params (the decoder inside is
    unused); ``noise``: (B, 4) box noise (:func:`draw_box_noise`)."""
    opt = Prodigy(learning_rate=cfg.learning_rate, weight_decay=0.0)

    def train_step(state: Dict, frozen: Dict, batch: Dict, noise: torch.Tensor):
        loss, grads = segmenter_grads(sam, cfg, state["decoder"], frozen, batch, noise)
        updates, opt_state = opt.update(grads, state["opt_state"], state["decoder"])
        decoder = apply_updates(state["decoder"], updates)
        return ({"decoder": decoder, "opt_state": opt_state, "step": state["step"] + 1},
                {"loss": loss})

    return train_step


def init_segmenter_state(sam_params: Dict, cfg: SegmenterTrainConfig) -> Dict:
    decoder = unflatten({k: v.detach().clone()
                         for k, v in flatten(sam_params["mask_decoder"]).items()})
    opt = Prodigy(learning_rate=cfg.learning_rate, weight_decay=0.0)
    return {"decoder": decoder, "opt_state": opt.init(decoder), "step": 0}

"""Try-on preprocessing: photos -> the masked conditioning images.

Counterpart of edgestyle_tpu/pipelines/preprocess.py (the reference's
create_sam_images, extract_dataset.py:353-511), for a batch of photos:

  1. one SAM image encoding per photo (the reference runs five encoders);
  2. the base decoder prompted with the photo's valid pose keypoints ->
     coarse person mask -> its bounding box (+20 px margin);
  3. the four finetuned decoder heads (subject, agnostic, clothes, head)
     prompted with that box;
  4. mask algebra: closing then smoothing of each head's mask (a 7 x 7
     closing for the head), union -> largest connected component ->
     smoothing; the agnostic/clothes overlap removed from both; every mask
     clipped to the person;
  5. gray-background composites of the photo.

Images are (B, 3, H, W) in [0, 1] at the SAM working size, masks (B, H, W)
bool. The JAX app vmaps its one-photo program over a batch; here every
step takes the batch natively, so one encoder call serves every photo.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from edgestyle_tpu_torch.models.efficientvit.sam import (
    SAM_L2,
    EfficientViTSam,
    SamConfig,
    postprocess_masks,
    preprocess_sam_image,
)
from edgestyle_tpu_torch.ops.morphology import (
    closing,
    composite_gray,
    largest_component,
    mask_bbox,
    smooth_mask,
)

HEAD_NAMES = ("subject", "agnostic", "clothes", "head")


class PreprocessOutput(NamedTuple):
    subject: torch.Tensor        # (B, 3, H, W) person on gray
    agnostic: torch.Tensor       # (B, 3, H, W) person minus clothes on gray
    head: torch.Tensor           # (B, 3, H, W) head on gray
    clothes: torch.Tensor        # (B, 3, H, W) clothes on gray
    agnostic_mask: torch.Tensor  # (B, H, W) bool
    person_mask: torch.Tensor    # (B, H, W) bool
    subject_score: torch.Tensor  # (B,) the subject head's predicted IoU (the
    # reference's sam_scores: extract_dataset.py:378-391 gates frames on it)


class TryOnPreprocessor:
    """params: {'sam': base EfficientViTSam params, 'decoders': {head name:
    mask_decoder subtree}}. The four finetuned heads share the base image
    and prompt encoders (only the decoder was trained,
    segmenter_training_*.py:145-147)."""

    def __init__(self, cfg: SamConfig = SAM_L2, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.sam = EfficientViTSam(cfg, dtype=dtype)
        self.prompt_scale = cfg.prompt_input_size / cfg.image_size

    def _decode_with(self, params: Dict, decoder_params, embedding, points, labels,
                     multimask: bool):
        p = params["sam"]
        if decoder_params is not None:
            p = {**p, "mask_decoder": decoder_params}
        return self.sam.decode(p, embedding, points, labels, multimask_output=multimask)

    @torch.no_grad()
    def __call__(self, params: Dict, image01: torch.Tensor,
                 keypoints: torch.Tensor) -> PreprocessOutput:
        """image01: (B, 3, H, W) in [0, 1] at the SAM working size (512).
        keypoints: (B, 18, 2) pixel coords in the same frame, NaN = missing."""
        b, _, h, w = image01.shape
        image01 = image01.float()
        embedding = self.sam.encode_image(params["sam"], preprocess_sam_image(image01))

        # 1. coarse person mask from the pose keypoints (base decoder)
        valid = torch.isfinite(keypoints[..., 0])
        pts = torch.nan_to_num(keypoints.float()) * self.prompt_scale
        lbl = torch.where(valid, 1, -1)
        masks, _ = self._decode_with(params, None, embedding, pts, lbl, True)
        coarse = postprocess_masks(masks.float(), (h, w))[:, 0] > 0

        # 2. box prompt (+20 px margin, reference getBox)
        box = mask_bbox(coarse, margin=20).float() * self.prompt_scale
        bpts = torch.stack([box[:, :2], box[:, 2:]], dim=1)  # (B, 2, 2)
        blbl = torch.tensor([2, 3], device=box.device).expand(b, 2)

        raw, iou = {}, {}
        for name in HEAD_NAMES:
            m, iou[name] = self._decode_with(params, params["decoders"][name], embedding, bpts,
                                             blbl, False)
            raw[name] = postprocess_masks(m.float(), (h, w))[:, 0] > 0
        all_m, agnostic_f, clothes_f, head_f = combine_masks(**raw)
        return PreprocessOutput(
            subject=composite_gray(image01, all_m),
            agnostic=composite_gray(image01, agnostic_f),
            head=composite_gray(image01, head_f),
            clothes=composite_gray(image01, clothes_f),
            agnostic_mask=agnostic_f,
            person_mask=all_m,
            subject_score=iou["subject"][:, 0].float(),
        )

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random init: the base SAM, and the four heads as copies of its decoder."""
        base = self.sam.init_params(generator)
        dec = base["mask_decoder"]
        return {"sam": base, "decoders": {n: copy_tree(dec) for n in HEAD_NAMES}}


def combine_masks(subject: torch.Tensor, agnostic: torch.Tensor, clothes: torch.Tensor,
                  head: torch.Tensor):
    """The mask algebra (module docstring, step 4) on the four heads' raw
    (B, H, W) bool masks -> (person, agnostic, clothes, head) masks."""
    subject, agnostic, clothes = (smooth_mask(closing(m, 3), 3, 3)
                                  for m in (subject, agnostic, clothes))
    head = smooth_mask(closing(head, 7), 3, 3)

    # union -> largest component -> smooth (the person's silhouette)
    person = smooth_mask(largest_component(subject | clothes | head), 3, 3)

    # resolve the agnostic/clothes overlap, clip to the person
    unknown = agnostic & clothes
    return (person, agnostic & ~unknown & person, clothes & ~unknown & person,
            head & person)


def copy_tree(tree):
    return {k: copy_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

"""Dataset extraction: photo or video frames -> per-subject artifact folders
(the layout data/dataset.py and the trainers read).

Counterpart of edgestyle_tpu/apps/extract_dataset.py (the reference's
extract_dataset.py:112-784), with its rules:

  * the person box comes from the OpenPose detection itself (the largest
    filtered pose), where the reference runs YOLOv5 (:54, :527-543); a frame
    with no pose gets its box from SAM's automatic masks instead
    (:func:`person_box_from_auto_masks`), and the pose is tried again on
    the crop;
  * margin crop to a 512 px square around the person
    (create_processed_image :112-171);
  * the OpenPose skeleton render and keypoint JSON (:214-295);
  * the SAM artifacts through ``TryOnSystem.extract`` (:353-511);
  * frames whose subject-head SAM score is under ``score_threshold`` are
    dropped (:34, :391); ``top_k`` keeps the best frames by mean(subject
    score, CLIP-IQA of the subject composite) (:656-753);
  * existing subject folders and ``_skip_`` markers are respected
    (:762-782).

Outputs per subject: processed/ openpose/ openpose_json/ subject/ mask/
agnostic/ head/ clothes/.

    python -m edgestyle_tpu_torch.apps.extract_dataset --random_init \\
        --input frames_dir --output_dir dataset/subject0 --top_k 30 \\
        --tokenizer_dir clip-tok --clip_model clip-vit-large-patch14
    python -m edgestyle_tpu_torch.apps.extract_dataset --input video.mp4 \\
        --output_dir dataset/subject1 --sam_checkpoint l2.safetensors \\
        --bodypose_checkpoint body_pose.safetensors \\
        --sam_subject trained_decoder_subject.safetensors
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike


def person_box_from_pose(keypoints: np.ndarray, margin: float = 0.2,
                         hw=(512, 512)) -> Optional[np.ndarray]:
    """Bounding box around valid keypoints with relative margin."""
    fin = np.isfinite(keypoints[:, 0])
    if fin.sum() < 2:
        return None
    xs, ys = keypoints[fin, 0], keypoints[fin, 1]
    w, h = xs.max() - xs.min(), ys.max() - ys.min()
    x0 = xs.min() - margin * w
    x1 = xs.max() + margin * w
    y0 = ys.min() - margin * h * 1.5  # headroom
    y1 = ys.max() + margin * h
    return np.array([max(0, x0), max(0, y0), min(hw[1], x1), min(hw[0], y1)])


def person_box_from_auto_masks(
    preproc,
    sam_params,
    img01: np.ndarray,
    points_per_side: int = 8,
    chunk: int = 16,
    pred_iou_thresh: float = 0.7,
    stability_thresh: float = 0.85,
    area_frac=(0.03, 0.9),
) -> Optional[np.ndarray]:
    """Person localisation without a pose. The reference finds the person
    with YOLOv5 before pose detection (extract_dataset.py:54, 527-543), so a
    frame whose person is too small for a full-frame OpenPose is still
    cropped. Here SAM's automatic mask candidates over a point grid stand in
    (models/efficientvit/sam.py): the largest candidate whose area share is
    person-plausible (``area_frac`` excludes near-full-frame background and
    specks) gives the box, ``mask_bbox(margin=10)`` in the 256 px mask
    frame scaled to the image.

    img01: square (S, S, 3) float in [0, 1]. Returns [x0, y0, x1, y1] fp32
    in the image frame, or None when no candidate is plausible."""
    from edgestyle_tpu_torch.models.efficientvit.sam import (
        automatic_mask_candidates,
        preprocess_sam_image,
        select_auto_masks,
    )
    from edgestyle_tpu_torch.ops.morphology import mask_bbox

    params = sam_params["sam"]
    dev = params["prompt_encoder"]["pe_gaussian"].device
    x = torch.from_numpy(np.ascontiguousarray(img01, np.float32)).permute(2, 0, 1)[None]
    img = preprocess_sam_image(x.to(dev))
    masks, iou, stab = automatic_mask_candidates(preproc.sam, params, img,
                                                 points_per_side=points_per_side, chunk=chunk)
    cands = select_auto_masks(masks, iou, stab, pred_iou_thresh=pred_iou_thresh,
                              stability_thresh=stability_thresh)
    mh = int(masks.shape[-1])
    n_px = mh * mh
    lo, hi = area_frac
    best, best_area = None, 0
    for c in cands:
        a = int(c["segmentation"].sum())
        if lo * n_px <= a <= hi * n_px and a > best_area:
            best, best_area = c["segmentation"], a
    if best is None:
        return None
    box = mask_bbox(torch.from_numpy(best)[None], margin=10)[0].numpy().astype(np.float32)
    h, w = img01.shape[:2]
    return box * np.array([w, h, w, h], np.float32) / mh


def margin_crop_square(img: np.ndarray, box: np.ndarray, out_size: int = 512) -> np.ndarray:
    """Expand the box to a square, clamp, crop, resize (reference
    create_processed_image :112-171)."""
    from edgestyle_tpu_torch.data.transforms import resize_nearest

    h, w = img.shape[:2]
    x0, y0, x1, y1 = box
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    side = max(x1 - x0, y1 - y0)
    side = min(side, min(h, w))
    x0 = int(np.clip(cx - side / 2, 0, w - side))
    y0 = int(np.clip(cy - side / 2, 0, h - side))
    crop = img[y0: y0 + int(side), x0: x0 + int(side)]
    return resize_nearest(crop, (out_size, out_size))


def extract_subject(
    system,  # apps.tryon.TryOnSystem
    frames: List[np.ndarray],  # HWC uint8
    out_dir: str,
    top_k: Optional[int] = None,
    iqa=None,
    score_threshold: float = 0.5,
    skip_marker: str = "_skip_",
    stats: Optional[dict] = None,
) -> int:
    """Process frames into the artifact layout. Returns #frames written.

    Frames whose subject-head SAM score falls below ``score_threshold``
    are dropped (reference SUBJECT_SCORE_THRESHOLD=0.5,
    extract_dataset.py:34,391). ``top_k`` ranking uses
    mean(subject_score, CLIP-IQA of the subject composite), the
    reference's score = mean(sam_scores, mean_score) (:699-714); without
    an ``iqa`` the SAM score alone ranks, and with no ranking signal at all
    the first ``top_k`` frames are kept. The reference's extra top-half
    random subsample for very long videos (:707-711) is replaced by a
    deterministic top-k.

    When ``stats`` is a dict it is filled with per-frame accounting,
    including how many pose-less frames the SAM auto-mask fallback
    recovered (``box_fallback``) and dropped (``dropped_no_box``)."""
    if stats is None:
        stats = {}
    stats.update(box_from_pose=0, box_fallback=0, dropped_no_box=0,
                 dropped_no_pose_on_crop=0, dropped_low_score=0)
    if os.path.exists(os.path.join(out_dir, skip_marker)):
        return 0
    arts = ("processed", "openpose", "openpose_json", "subject", "mask",
            "agnostic", "head", "clothes")
    for a in arts:
        os.makedirs(os.path.join(out_dir, a), exist_ok=True)

    from PIL import Image

    from edgestyle_tpu_torch.data.transforms import standard_image

    results = []
    for idx, frame in enumerate(frames):
        img512 = standard_image(frame)
        kp, skel = system.detect_pose(img512.astype(np.float32) / 255.0)
        box = person_box_from_pose(kp) if kp is not None else None
        if box is not None:
            stats["box_from_pose"] += 1
        else:
            # the reference crops before the pose, so a person too small
            # for a full-frame OpenPose is still kept: a SAM auto-mask
            # gives the box, and the pose is tried again on the crop
            if getattr(system, "preproc", None) is not None and getattr(
                system, "sam_params", None
            ) is not None:
                box = person_box_from_auto_masks(
                    system.preproc, system.sam_params,
                    img512.astype(np.float32) / 255.0,
                )
            if box is None:
                stats["dropped_no_box"] += 1
                continue
            stats["box_fallback"] += 1
        processed = margin_crop_square(img512, box)
        kp2, skel2 = system.detect_pose(processed.astype(np.float32) / 255.0)
        if kp2 is None:
            # the reference drops pose-less frames too (create_sam_images
            # returns all-None without openpose_json, :353-358, and
            # process_data filters them, :661-668)
            stats["dropped_no_pose_on_crop"] += 1
            continue
        ex = system.extract(processed.astype(np.float32) / 255.0, kp2)
        if ex.get("subject_score", 1.0) < score_threshold:
            stats["dropped_low_score"] += 1
            continue
        results.append((idx, processed, skel2, kp2, ex))

    if top_k is not None and len(results) > top_k:
        scores = []
        for p in results:
            ex = p[4]
            parts = []
            if "subject_score" in ex:
                parts.append(float(ex["subject_score"]))
            if iqa is not None:
                # the reference scores the SUBJECT composite (:685-692)
                subj = torch.from_numpy(np.asarray(ex["subject"], np.float32)[None])
                parts.append(float(iqa(subj)[0]))
            scores.append(float(np.mean(parts)) if parts else 0.0)
        if any(scores):
            order = np.argsort(scores)[::-1][:top_k]
            results = [results[i] for i in sorted(order)]
        else:
            # no ranking signal at all (extract() without subject_score and
            # no iqa): keep the FIRST top_k in frame order rather than
            # letting a reversed zero-tie argsort keep the last
            results = results[:top_k]

    for idx, processed, skel, kp, ex in results:
        name = f"{idx:06d}"
        Image.fromarray(processed).save(os.path.join(out_dir, "processed", name + ".jpg"))
        Image.fromarray((skel * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "openpose", name + ".jpg"))
        with open(os.path.join(out_dir, "openpose_json", name + ".json"), "w") as f:
            json.dump({"keypoints": np.where(np.isfinite(kp), kp, -1).tolist()}, f)
        for art, key in (("subject", "subject"), ("agnostic", "agnostic"),
                         ("head", "head"), ("clothes", "clothes")):
            Image.fromarray((ex[key] * 255).astype(np.uint8)).save(
                os.path.join(out_dir, art, name + ".jpg"))
        mask01 = (ex["agnostic"] != 127 / 255).any(axis=-1).astype(np.uint8) * 255
        Image.fromarray(np.stack([mask01] * 3, -1)).save(
            os.path.join(out_dir, "mask", name + ".jpg"))
    return len(results)


def load_frames(path: str, every_n: int = 1) -> List[np.ndarray]:
    """Directory of images, or a video file via cv2."""
    from PIL import Image

    if os.path.isdir(path):
        out = []
        for i, f in enumerate(sorted(os.listdir(path))):
            if i % every_n:
                continue
            if f.lower().endswith((".jpg", ".jpeg", ".png")):
                with Image.open(os.path.join(path, f)) as im:
                    out.append(np.asarray(im.convert("RGB")))
        return out
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every_n == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    return frames


def parse_args(argv=None):
    from edgestyle_tpu_torch.apps.tryon import add_model_source_args

    p = argparse.ArgumentParser(description="EdgeStyle dataset extraction (PyTorch/CUDA)")
    p.add_argument("--input", type=str, required=True, help="video file or image dir")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--every_n", type=int, default=5)
    p.add_argument("--top_k", type=int, default=None,
                   help="keep the best frames by mean(SAM subject score, "
                        "CLIP-IQA), the reference's MAX_FRAMES selection "
                        "(:699-714); IQA needs --tokenizer_dir and --clip_model")
    p.add_argument("--score_threshold", type=float, default=0.5,
                   help="drop frames whose subject-head SAM score is below "
                        "this (reference SUBJECT_SCORE_THRESHOLD, :34)")
    p.add_argument("--tokenizer_dir", type=str, default=None)
    p.add_argument("--clip_model", type=str, default=None,
                   help="full CLIPModel dir enabling the CLIP-IQA half of "
                        "the frame ranking")
    p.add_argument("--random_init", action="store_true")
    add_model_source_args(p)
    return p.parse_args(argv)


def main(argv=None, device: DeviceLike = "cuda") -> dict:
    """Run the extraction; prints and returns the JSON stats line."""
    args = parse_args(argv)
    from edgestyle_tpu_torch.apps.tryon import TryOnSystem

    iqa = None
    if args.tokenizer_dir and args.clip_model:
        from edgestyle_tpu_torch.data.curation import (
            EXTRACTION_PROMPT_PAIRS,
            ClipIQA,
            _clip_encoders,
        )

        tok, enc_img, enc_txt = _clip_encoders(args.tokenizer_dir, args.clip_model, device)
        iqa = ClipIQA(tok, enc_img, enc_txt, EXTRACTION_PROMPT_PAIRS)

    system = TryOnSystem(random_init=args.random_init, args=args, device=device)
    frames = load_frames(args.input, args.every_n)
    stats: dict = {}
    n = extract_subject(system, frames, args.output_dir, top_k=args.top_k,
                        iqa=iqa, score_threshold=args.score_threshold,
                        stats=stats)
    line = {"frames_in": len(frames), "frames_written": n, **stats}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()

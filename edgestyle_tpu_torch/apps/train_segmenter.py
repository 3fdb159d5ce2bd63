"""The segmenter finetuner's entry point: the reference's four trainers
(segmenter_training_{subject,head,clothes,body}.py) as one CLI set by
``--head`` (they differ only in their KEEP_CATEGORIES subsets and output
paths).

Counterpart of edgestyle_tpu/apps/train_segmenter.py, with its flags,
defaults and JSON lines:

  * data: human-parsing image/label pairs from a local folder (images/ and
    masks/ with matching stems), a 99/1 train/val split (:419-423), batches
    in ``np.random.default_rng(seed).permutation`` order, so that both
    packages see the same batches;
  * only the mask decoder trains, against box prompts jittered by
    ``--box_jitter`` px, with the DiceCE loss and Prodigy at lr 1.0
    (training/segmenter.py);
  * per-epoch mask overlay grids to TensorBoard (tensorboardX, where it is
    installed), predicted from the un-jittered box (:296-358);
  * the best epoch's decoder (lowest train loss, :438-444) goes to
    ``trained_decoder_{head}.safetensors``: the JAX package's keys, shapes
    and fp32 values (training/checkpoint.py::export_safetensors). The
    try-on, the server and the extractor take it as ``--sam_subject``,
    ``--sam_agnostic`` (the body-trained decoder), ``--sam_clothes`` or
    ``--sam_head`` (apps/tryon.py::_load_sam_params reads this layout).

The weights come from ``--sam_checkpoint`` (an upstream EfficientViT-SAM
state dict, ``.safetensors`` or ``.pt``) or, with ``--random_init``, from
``--seed``. Everything runs in fp32, with TF32 off on the card.

    python -m edgestyle_tpu_torch.apps.train_segmenter --head clothes \\
        --dataset_dir parsing_data --sam_checkpoint l2.safetensors --output_dir out
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EdgeStyle segmenter finetuner (PyTorch/CUDA)")
    p.add_argument("--head", type=str, default="subject",
                   choices=["subject", "head", "clothes", "body"])
    p.add_argument("--dataset_dir", type=str, default=None,
                   help="folder with images/ and masks/ (matching stems; "
                        "masks are uint8 parsing-label PNGs)")
    p.add_argument("--sam_checkpoint", type=str, default=None,
                   help="base EfficientViT-SAM weights (.pt or .safetensors)")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--epochs", type=int, default=20)  # reference Trainer max_epochs
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--val_fraction", type=float, default=0.01)  # 99/1 split
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--box_jitter", type=int, default=30)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop early after N optimizer steps (0 = full run)")
    p.add_argument("--overlay_samples", type=int, default=4)
    p.add_argument("--output_dir", type=str, default="./segmenter-out")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def load_parsing_folder(root: str, image_size: int):
    """images/ + masks/ folders -> (images01 (N,S,S,3) fp32, labels (N,S,S)
    int32), SamResize semantics: longest side -> image_size, corner pad
    (reference SamResize/SamPad, efficientvit sam.py:51-106)."""
    from PIL import Image

    img_dir, mask_dir = os.path.join(root, "images"), os.path.join(root, "masks")
    stems = sorted(
        os.path.splitext(f)[0] for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    imgs, labs = [], []
    for stem in stems:
        ipath = next(
            os.path.join(img_dir, stem + ext)
            for ext in (".png", ".jpg", ".jpeg")
            if os.path.isfile(os.path.join(img_dir, stem + ext))
        )
        mpath = os.path.join(mask_dir, stem + ".png")
        with Image.open(ipath) as im:
            im = im.convert("RGB")
            scale = image_size / max(im.size)
            nw, nh = round(im.width * scale), round(im.height * scale)
            arr = np.asarray(im.resize((nw, nh), Image.BILINEAR), np.float32) / 255.0
        with Image.open(mpath) as mm:
            lab = np.asarray(mm.resize((nw, nh), Image.NEAREST), np.int32)
            if lab.ndim == 3:
                lab = lab[..., 0]
        canvas = np.zeros((image_size, image_size, 3), np.float32)
        canvas[:nh, :nw] = arr
        lcanvas = np.zeros((image_size, image_size), np.int32)
        lcanvas[:nh, :nw] = lab
        imgs.append(canvas)
        labs.append(lcanvas)
    if not imgs:
        raise SystemExit(f"no images under {img_dir}")
    return np.stack(imgs), np.stack(labs)


def overlay_grid(images01, target, pred):
    """(B,S,S,3)+2x(B,S,S) -> one (S, B*S, 3) row: image tinted green where
    GT, red where prediction (the reference's per-epoch TensorBoard
    artifact, segmenter_training_subject.py:296-358)."""
    out = []
    for img, t, pr in zip(images01, target, pred):
        o = img.copy()
        o[..., 1] = np.where(t, 0.6 * o[..., 1] + 0.4, o[..., 1])
        o[..., 0] = np.where(pr, 0.6 * o[..., 0] + 0.4, o[..., 0])
        out.append(o)
    return np.concatenate(out, axis=1)


def _nchw(images01: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images01)).permute(0, 3, 1, 2).to(dev)


def main(argv=None, sam_cfg=None, device: DeviceLike = "cuda"):
    """Train; returns the last train state and the frozen SAM params.
    ``sam_cfg``: a SamConfig in place of the production SAM_L2 (the
    architecture of all five reference checkpoints), for tests."""
    args = parse_args(argv)
    from edgestyle_tpu_torch.core.porting import load_state_dict, tree_from_flat
    from edgestyle_tpu_torch.models.efficientvit.sam import (
        SAM_L2,
        EfficientViTSam,
        port_sam_state_dict,
        postprocess_masks,
        preprocess_sam_image,
    )
    from edgestyle_tpu_torch.training.checkpoint import export_safetensors
    from edgestyle_tpu_torch.training.segmenter import (
        SegmenterTrainConfig,
        binary_target,
        draw_box_noise,
        init_segmenter_state,
        jittered_box,
        make_segmenter_train_step,
    )

    dev = resolve_device(device)
    if dev.type == "cuda":  # fp32 throughout, as the JAX trainer computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = sam_cfg if sam_cfg is not None else SAM_L2
    sam = EfficientViTSam(cfg)
    gen = make_generator(args.seed, dev)
    if args.random_init or not args.sam_checkpoint:
        frozen = sam.init_params(gen)
    else:
        frozen = tree_from_flat(port_sam_state_dict(load_state_dict(args.sam_checkpoint, dev),
                                                    cfg), dev)

    tcfg = SegmenterTrainConfig(head=args.head, learning_rate=args.learning_rate,
                                box_jitter=args.box_jitter)
    state = init_segmenter_state(frozen, tcfg)
    step_fn = make_segmenter_train_step(sam, tcfg)

    # data
    if args.dataset_dir:
        images01, labels = load_parsing_folder(args.dataset_dir, cfg.image_size)
    else:  # synthetic smoke data
        g = np.random.default_rng(args.seed)
        images01 = g.random((8, cfg.image_size, cfg.image_size, 3), np.float32)
        labels = np.zeros((8, cfg.image_size, cfg.image_size), np.int32)
        s = cfg.image_size
        labels[:, s // 4: 3 * s // 4, s // 4: 3 * s // 4] = 5  # a "clothes" block
        labels[:, s // 8: s // 4, 3 * s // 8: 5 * s // 8] = 2  # a "hair" block
    n_val = max(1, int(len(images01) * args.val_fraction)) if len(images01) > 1 else 0
    images01, labels = images01[n_val:], labels[n_val:]
    if len(images01) < args.batch_size:
        raise SystemExit(
            f"training set after the val split has {len(images01)} examples "
            f"< --batch_size {args.batch_size}: every epoch would run zero "
            f"steps. Add data or lower --batch_size."
        )
    print(json.dumps({"train": len(images01), "val": int(n_val), "head": args.head}),
          flush=True)

    os.makedirs(args.output_dir, exist_ok=True)
    try:
        from tensorboardX import SummaryWriter

        writer = SummaryWriter(os.path.join(args.output_dir, "logs"))
    except Exception:
        writer = None

    prompt_scale = cfg.prompt_input_size / cfg.image_size

    @torch.no_grad()
    def predict(decoder, img01, labs):
        """The un-jittered box path (the reference's validation_step)."""
        emb = sam.encode_image(frozen, preprocess_sam_image(img01))
        t = binary_target(labs, args.head)
        pts, lbls = jittered_box(t, torch.zeros((t.shape[0], 4), device=dev), prompt_scale)
        masks, _ = sam.decode({**frozen, "mask_decoder": decoder}, emb, pts, lbls,
                              multimask_output=False)
        logits = postprocess_masks(masks.float(), img01.shape[2:])[:, 0]
        return logits > 0, t

    g = np.random.default_rng(args.seed)
    best = {"loss": float("inf"), "epoch": -1}
    gstep = 0
    t0 = time.time()
    done = False
    for epoch in range(args.epochs):
        order = g.permutation(len(images01))
        losses = []
        for i0 in range(0, len(order) - args.batch_size + 1, args.batch_size):
            idx = order[i0: i0 + args.batch_size]
            batch = {"image": preprocess_sam_image(_nchw(images01[idx], dev)),
                     "labels": torch.from_numpy(labels[idx]).to(dev)}
            noise = draw_box_noise(gen, len(idx), args.box_jitter)
            state, metrics = step_fn(state, frozen, batch, noise)
            losses.append(float(metrics["loss"]))
            gstep += 1
            if args.max_steps and gstep >= args.max_steps:
                done = True
                break
        ep_loss = float(np.mean(losses)) if losses else float("nan")
        print(json.dumps({"epoch": epoch, "train_loss": round(ep_loss, 4),
                          "step": gstep, "elapsed_s": round(time.time() - t0, 1)}),
              flush=True)
        if writer:
            writer.add_scalar("train_loss", ep_loss, epoch)

        # per-epoch overlay grid
        k = min(args.overlay_samples, len(images01))
        if k and writer:
            pred, t = predict(state["decoder"], _nchw(images01[:k], dev),
                              torch.from_numpy(labels[:k]).to(dev))
            grid = overlay_grid(images01[:k], t.cpu().numpy(), pred.cpu().numpy())
            writer.add_image(f"overlay_{args.head}", grid, epoch, dataformats="HWC")

        if ep_loss < best["loss"]:
            best = {"loss": ep_loss, "epoch": epoch}
            export_safetensors(
                os.path.join(args.output_dir, f"trained_decoder_{args.head}.safetensors"),
                state["decoder"],
            )
        if done:
            break

    if writer:
        writer.close()
    print(json.dumps({"done": True, "best_epoch": best["epoch"],
                      "best_loss": round(best["loss"], 4), "steps": gstep}),
          flush=True)
    return state, frozen


if __name__ == "__main__":
    main()

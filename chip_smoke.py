"""Chip smoke test of the PyTorch/CUDA port (edgestyle_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --profile OUT_DIR  # + profiled generation, serving runs, training step

Phases, each of which ends the run with a non-zero exit on failure:

  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. kernel phase: every hand-written kernel against its plain PyTorch
     version on the card, at the full-width shapes its path gives it (the
     fused conv and the GN statistics also on the fp32 x of the LoRA
     trunks' first convs; the flash forward also at the serving knobs'
     shapes), with its time, the plain version's time, one
     PyTorch library call of the same function as a yardstick (never used by
     the port) and the least time the card could take (the bound); and the
     fused conv's bf16 activations against bf16(exact silu), on bf16 and
     fp32 x;
  3. generation phase: the full-width SD1.5 6-branch try-on
     (``EdgeStylePipeline.__call__``, 512 px, 20 UniPC steps, bf16) from the
     port's random init, for a few requests, with the kernels' launch counts
     read around the requests against the counts the code predicts;
  4. end-to-end check: the same generation at 2 steps through the kernels
     and through the ops' plain versions, image max-abs difference under a
     stated bf16 tolerance;
  4b. photos -> try-on (``tryon_system``): ``apps/tryon.py::TryOnSystem`` at
     full width (BodyPoseNet at 184 px fp32, EfficientViT-L2-SAM at 512 px
     bf16 with four decoder heads, the generation phase's pipeline and
     params) on three 512 px photos made with numpy: the pose net's, the
     SAM encoder's (+ one decode) and the preprocessing's times at B=1 and
     B=2 triples, the device launches of one preprocessing, one full
     ``__call__`` at 20 steps with the generation's launch counts against
     the prediction, and checks: composites finite in [0, 1], skeleton
     renders of the right shape, ``prepare_cond_batch`` against
     per-request ``prepare_cond``, the fp32 SAM-L2 embedding and one
     decode's mask logits on the card against the same code on the CPU
     (TF32 off; a TF32-on run is read, not held), a skeleton render on the
     card against the CPU's, and, since random weights give masks that
     cover the photo and find no person, inputs with structure made here:
     the mask algebra on 512 px head masks with a body, a head, a stray
     disc and specks, ``largest_component`` on a serpentine and three
     discs, the pose decode on synthetic maps of known people, each equal
     on the card and the CPU and to its known answer; a
     ``{"tryon_system": ...}`` line holds its numbers;
  4c. serving (``serving_phase``): the serving knobs at full width on the
     generation phase's pipeline and params, 512 px, B=1: the exact
     program, each ``--mode`` preset of apps/tryon.py (conservative,
     quality, aggressive, turbo) and DPM++ at 20 steps, ``--mode lcm`` (4
     steps) on the UNet merged with a seeded rank-64 LCM-LoRA, and a ToMe
     ratio (0.3) whose merged 2868 tokens are off the flash kernel's tile
     grid; each one warm-up and SERVING_TIMED timed requests, the kernels' launches
     against the counts the code predicts, the image's difference from the
     exact one printed (not held); held: the knobs at their exact values
     give the exact image bit for bit, ``shallow_forward`` on the deep
     feature of the same (sample, t) equals the UNet's output bit for bit,
     ``cfg_interval`` (0, 0) against guidance 1.0 and turbo through the
     kernels against the ops' plain versions (4 steps) within the
     end-to-end tolerance, ToMe's merge rows on the card equal the CPU's; a
     ``{"serving": ...}`` line holds its numbers;
  4d. int8 (``int8_phase``): W8A8 int8 serving. The op check: at the
     denoise step's hot shapes (3x3 convs (6, 320, 64, 64) -> 320, the
     up-block concat (6, 960, 64, 64) -> 320, (2, 1280, 8, 8) -> 1280 and a
     stride-2 downsample; Dense (2, 4096, 320) -> 320 and a (2, 77, 768) ->
     320 cross-attention K) the card's route (im2col + ``torch._int_mm``)
     against the plain route on the CPU (fp64, exact): weight and
     activation q and s, int32 accumulators and dequantised outputs bit for
     bit, a shifted im2col tap and a weight scale one ulp off each rejected;
     the int8 op's, ``_int_mm``'s (beside its int8 bound), the bf16 fused
     conv's and cuDNN's ``F.conv2d`` times. Then "int8" and "int8-static"
     (calibrated here, its table saved) beside the exact program at 512 px,
     20 UniPC steps, B=1 and B=2: walls, each generation's launches (440
     flash, only the VAE's 48 GN statistics / fused conv) and int8 products
     (178 convs and 444 Dense a step) against the prediction, the mean
     |int8 - exact| read (not held), and the saved table in a fresh
     pipeline reproducing its image bit for bit; an ``{"int8": ...}`` line;
  4e. serve (``serve_phase``): apps/serve.py's server in this process on
     127.0.0.1 (a free port), ``--random_init --max_batch 2``, the
     generation's pipeline and params, EDGESTYLE_QUANT unset: /healthz,
     three concurrent 512 px requests at 20 steps of which two coalesce into
     one B=2 generation, each of those two served alone by a server without
     batching and compared (SERVE_MEAN_TOL / SERVE_MAX_TOL), a malformed
     request's 400 and a request after it; then ``--int8_scales`` (4d's
     table) with EDGESTYLE_QUANT=int8-static, one request; a ``{"serve":
     ...}`` line;
  4f. export (``export_phase``): the deployment export at full width, bf16,
     B=1, into build/torch_ext/chip_smoke_export/: ``apps/export.py::main
     --random_init --what all`` (five ``torch.export`` programs, each
     reload held to the live function; trace, save and reload seconds, file
     sizes, graph nodes); each reloaded graph on the live pipeline's inputs
     with the launches the code predicts; a 20-step host-loop generation
     through ``ArtifactPipeline`` against the live ``__call__`` on the same
     latents (E2E_TOL, the generation's 440 / 2,128 / 2,128 launches); the
     ``--mode aggressive`` generate program (cut to EXPORT_GENERATE_STEPS)
     served against the live pipeline under the same knobs and refusing a
     request without them; ``apps/tryon.py::main --exported_dir``;
     ``entry()``'s step; the operators' host cost a call against the ctypes
     wrapper and a ``custom_op``; an ``{"export": ...}`` line;
  5. training phase: the ControlLoRA trainer's entry point
     (``apps/train.py::main``) at full width, 512 px, micro-batch 2, 3
     steps of Prodigy with Min-SNR-gamma 5, from the port's random init,
     with the kernels' launch counts read around the run against the counts
     the code predicts; finite losses, a monotone d, every trainable group
     moved, the frozen weights unchanged and the checkpoint read back equal;
  6. gradient check: one micro-batch's loss and trainable gradients at B=1
     through the kernels and through the ops' plain versions, the relative
     L2 difference of each trainable group and of each leaf under stated
     tolerances; then two planted faults (dq set to 0, dv set to 0), each
     of which the same check must reject;
  7. fp32 training: one step of the same entry point with
     ``--mixed_precision no`` (micro-batch 1): an fp32 model runs its long
     attentions through the flash kernels on q, k, v and dO rounded to
     bf16 (the launches of a bf16 step) and its convs through the plain
     version (no GN statistics or conv launch); the loss is finite;
  8. pretrained (``pretrained_phase``): full-width diffusers/HF files in a
     temporary directory, written by the port's own safetensors writer with
     values drawn on the card from a seed: the SD1.5 UNet, the openpose
     ControlNet (key manifests from tests/torch_sd15.py's modules on the
     meta device; UNet 859,520,964 and VAE 83,653,863 parameters) and the
     CLIP-L text tower (HF's key grammar, I64 position_ids) in fp16, the VAE
     in fp32, a reference-layout trained set at rank 32 with conv adapters
     (``export_reference_layout``), and SAM-L2 with four heads and the
     body-pose net from the port's own init (upstream keys, the mappers'
     rules run backwards); each model's write and load time; the tree of
     ``load_pipeline_params`` against ``init_params``'s recorded on the
     meta device (keys, shapes, norms fp32, the rest bf16, 4-D leaves
     channels_last), the trained set, SAM, pose and spot UNet leaves read
     back bitwise; then ``apps/tryon.py::main`` without ``--random_init``
     on three 512 px PNG photos with every loader flag (a finite [0, 1]
     image, the generation's launches) and ``apps/train.py::main`` from the
     same directories (one step at micro-batch 1: a finite loss, a step's
     launches, its two exports of the trained set read back bitwise); a
     ``{"pretrained": ...}`` line holds its numbers;
  9. mined_tryon (``mined_tryon_phase``): a seeded full-width CLIPModel file
     (the CLIP-L text tower and ViT-L/14 with their projections, fp32,
     427,616,513 parameters) and the byte tokenizer's files;
     ``apps/tryon.py::main`` with ``--random_init --tokenizer_dir
     --clip_model`` on three 512 px photos: the printed prompt is
     "edgestyle, " and two colours and two garments of the banks, the
     image finite in [0, 1], the generation's launches; the miner's ms per
     image at B=1 (median of 10) and its vision forward's share; the card's
     image embedding against the same tower on the CPU (fp32, TF32 off) and
     each bank's top-2 logit margin: the CPU must mine the same prompt
     unless every margin is within the error; a ``{"mined_tryon": ...}``
     line;
  10. data_training (``data_training_phase``): a seeded dataset of 2
     subjects x 3 frames x the six artifact folders (512 px JPEGs, 12
     triples); the loader's host seconds per batch at 0 and 2 workers;
     ``apps/train.py::main`` on it (micro-batch 2, 512 px, 3 steps, 2
     workers and prefetch, every ``--proportion_*`` at 0.2, validation every
     2 steps where tensorboardX is installed) with the training phase's
     checks, its launches against 3 steps' and the app's validation's
     prediction, its steady s/step beside the synthetic loader's; a
     ``{"data_training": ...}`` line;
  11. validation (``validation_phase``): ``log_validation`` on that run's
     trained state and first micro-batch at 512 px, b = 2, the four default
     guidance scales, 8 steps: a finite [0, 1] grid of (7 x 512, 2 x 512, 3),
     the launches against 176 flash and 880 GN statistics / conv per scale,
     each scale's seconds; a ``{"validation": ...}`` line;
  12. distill (``distill_phase``): ``apps/distill.py::main`` at full width
     (512 px, bf16, rank-64 LCM-LoRA over the whole UNet, micro-batch 2)
     from ``--random_init`` on the synthetic loader: 3 consistency steps
     with an EMA target (0.95) and a checkpoint every 2, one more step
     resumed from the latest checkpoint, 3 guidance steps (w pinned at 4)
     with a checkpoint each; each run's launches against the counts the
     code predicts (54 flash, 292 GN statistics / conv, 10 dq and dk/dv a
     consistency step; 32 / 188 / 10 / 10 a guidance step), its
     seconds per step and peak memory; held: finite losses, guidance step
     1 moves every up adapter off zero and no down, step 2 every down, the
     EMA target's recurrence and its place between its start and the online
     adapters, the frozen weights unchanged, the checkpoints and
     ``lcm_lora.safetensors`` read back equal, the resumed run starting at
     step 3; a ``{"distill": ...}`` line;
  13. distill_grad_check (``distill_grad_check_phase``): one consistency
     micro-batch at B=1, the LCM-LoRA gradients through the kernels and
     through the plain versions, per adapter group (down blocks, mid block,
     up blocks, time embedding) within GRAD_TOL and per leaf within
     LEAF_TOL; a planted dq = 0 fault must be rejected;
  14. lcm_serving (``lcm_serving_phase``): ``apps/tryon.py::main
     --random_init --mode lcm --lcm_lora`` on phase 12's first run's
     adapters and three 512 px photos: a finite [0, 1] image with the lcm
     preset's launches (88 flash, 464 GN statistics / conv), and the
     request's time; a ``{"lcm_serving": ...}`` line;
  15. infer (``infer_phase``): ``apps/infer.py::main --random_init`` on
     three artifact directories of 512 px PNGs: one image at 20 steps (the
     generation's 440 / 2,128 / 2,128 launches) and a ``--guidance_sweep
     --steps 4`` grid of (1536, 1536, 3), the three sources and six
     generations (528 / 2,784 / 2,784), each generation finite in [0, 1]; an
     ``{"infer": ...}`` line;
  16. segmenter (``segmenter_phase``): a seeded parsing folder (9 non-square
     JPEG photos, PNG labels with blocks of every label the four heads
     keep) and ``apps/train_segmenter.py::main --random_init --head clothes
     --epochs 2 --batch_size 4 --max_steps 4`` at EfficientViT-L2-SAM, 512
     px, fp32 (TF32 off): its JSON lines, finite losses, the decoder moved
     (all but the IoU head and the three unused tokens' hypernetworks), the
     image and prompt encoders bit-unchanged; the exported decoder through
     the try-on's ``--sam_clothes`` (with the base SAM and a pose net written
     as upstream state dicts) bit-equal, and ``TryOnSystem.extract`` with it;
     the steady s/step of the library step at micro-batch 4, its device
     launches and peak memory; one step of each head card against CPU (loss
     within SEG_LOSS_TOL, each decoder gradient leaf within SEG_GRAD_TOL
     relative L2), a gradient leaf scaled by 1.1 rejected; no hand-written
     kernel launched; a ``{"segmenter": ...}`` line;
  17. auto_mask (``auto_mask_phase``): seeded SAM-L2 weights, one 512 px
     photo, ``automatic_mask_candidates`` at its defaults (16 x 16 points,
     chunks of 64: 768 candidates) on the card and the CPU: predicted IoU and
     stability within AUTO_SCORE_TOL, at most AUTO_MASK_SHARE_TOL of the
     mask pixels differing, ``select_auto_masks`` on both; ms per image,
     device launches, no hand-written kernel; an ``{"auto_mask": ...}``
     line;
  18. extract (``extract_phase``): six 1280 x 720 frames (one blank) and
     ``apps/extract_dataset.py::main --random_init --every_n 1 --top_k 2
     --score_threshold 0`` with CLIP-IQA on phase 9's ViT-L/14 CLIPModel
     file: its stats account for every frame (random weights find no
     person); then ``extract_subject`` with the same system, its pose net
     run but its keypoints replaced by a known person's, so every frame
     reaches SAM, the IQA and the disk (the score gate opened: random
     weights' predicted IoU means nothing): the top 2 of 6 frames written
     with all eight artifacts, ``find_missing_artifacts`` empty, ``curation.main
     bad`` at full width on the result; seconds per frame split into pose,
     SAM and IQA; no hand-written kernel; an ``{"extract": ...}`` line;
  19. multicard (``multicard_phase``): several cards on this one. (a) an
     NCCL group of one rank on cuda:0: ``generate_dp`` (full width, bf16,
     B=2, MC_STEPS UniPC steps) and one data-parallel train step
     (micro-batch 2) each equal to the single-process call bit for bit;
     (b) two processes that both name cuda:0 and ``gloo``: ``generate_dp``
     at B=2 (a row a rank) against (a)'s single-process images,
     ``generate_tp`` at model=2, B=1, against the single-process B=1 image,
     one data-parallel train step at a global micro-batch of 2 against the
     single-process step (loss, d, each group's gradient and update as
     relative L2; bf16 from the trainer's initial state and with live
     adapters, fp32 with live adapters),
     each rank's launches of the five kernels against the prediction and
     its TP all-reduces against the count the code predicts
     (``tp_all_reduces``); "int8" and "int8-static" ``generate_tp`` at
     model=2, B=1 against this rank's single-process int8 image (each
     recording its own table under int8-static) at MC_INT8_LEVEL_TOL, the
     int8 products equal, the model group's collectives as predicted
     (``tp_int8_collectives``), the table recorded under TP within
     MC_INT8_TABLE_TOL of the single process's, and a planted fault (each
     rank's own absmax) outside both limits; (c) four processes on cuda:0 and
     ``gloo``, the (data 2, model 2) mesh: the DP x TP train step
     (``shard_pipeline_frozen_tp``, ``make_train_step`` with a model
     group) at a global micro-batch of 2 with live adapters, bf16 and fp32,
     each group's gradient, the loss and d against (a)'s single-process
     step, a planted fault (the LoRA merge's model-group sum left out)
     rejected, the forward and backward collectives and their bytes as
     predicted (``dptp_collectives``), the launches as the single
     process's, the new state saved and resumed with
     ``load_checkpoint_sharded`` bit for bit, seconds and peak memory a
     rank; per rank the seconds (ranks share the card: not a speed-up),
     all-reduces and bytes; a ``{"multicard": ...}`` line. A failure in
     any rank fails the phase;
  20. zoo (``zoo_phase``): the EfficientViT model zoo, fp32 with TF32 off:
     ``create_seg_model`` b1 (cityscapes) and l2 (ade20k) at 512 px,
     ``create_cls_model`` b3 and l2 at 224 px, seeded weights, B=1: the
     card against the CPU within ZOO_REL_TOL, ms a forward, and each
     ``port_fn`` on an upstream-named state dict synthesised from the tree
     (``upstream_state_dict``) giving the tree back bit for bit; a
     ``{"zoo": ...}`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the ``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import argparse
import atexit
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published dense peaks (NVIDIA data sheet), used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
# Exponentials per second of the special-function units: 132 SMs x 16 ex2 per
# clock per SM (the CUDA C++ Programming Guide's arithmetic-instruction
# throughput table, compute capability 9.0) at the 1.83 GHz that the bf16
# peak above implies (989e12 / (132 SMs x 4096 flops per clock)): ~3.9e12.
PEAK_EXP_PER_S = 132 * 16 * 1.83e9

# Kernel against plain version: max-abs error <= REL_TOL * max|plain output|,
# i.e. 2 to 4 bf16 ulps (8 significant bits) of the largest output. Set from
# the output's own scale: a softmax mix of N random v is ~N(0, e/N), far
# below |v|, so an absolute limit would pass a P*V that is off by a large
# share of its output.
REL_TOL = 2.0 ** -6
LSE_TOL = 1e-2     # fp32 row logsumexp of values ~log(N) + 0.5
# GN statistics kernel against the plain statistics, relative on s and on
# mean * s in t: fp32 sums in another order, 1e-4; for bf16 x the single-pass
# variance E[x^2] - E[x]^2 loses mean^2 / var of its fp32 rounding to
# cancellation, GN_CANCEL_TOL of that ratio (a mean of +40 at a spread of
# 1.1: 1e-4 + 2.6e-3).
GN_REL_TOL = 1e-4
GN_CANCEL_TOL = 2e-6
# The conv's bf16 activations against exact silu: a fast-math silu a few
# fp32 ulps from exact moves a bf16 rounding for ~2^-13 of the values, and
# then by one ulp.
ACT_SHARE_TOL = 1e-3
E2E_TOL = 0.1      # [0,1] images after 2 bf16 steps through 3 ControlNets + UNet + VAE
# Photos -> try-on phase. prepare_cond_batch against per-request
# prepare_cond, bf16 SAM: the encoder runs on 3B photos in one call or on
# one, and cuDNN may pick other algorithms for the two batch sizes, whose
# fp32 sums round to other bf16 values; a mask pixel whose logit is that
# close to 0 flips, and the mask algebra can move a few more. Per cond
# image at most COND_SHARE_TOL of the pixels may differ (by more than
# 1e-5 in any channel).
COND_SHARE_TOL = 0.01
# The fp32 SAM-L2 encoder embedding and one decode's mask logits, card
# (TF32 off for matmuls and cuDNN) against the CPU, same params and image:
# max-abs difference <= SAM_FP32_REL_TOL * max |CPU value|: fp32 sums in
# another order through ~100 layers read 5.3e-6 and 4.0e-6 on the H100; the
# limit is the card test's at MID size (tests/test_torch_preprocess_card.py).
SAM_FP32_REL_TOL = 1e-4
# A skeleton render on the card against the CPU's: pixels at a distance
# within an fp32 rounding of the capsule or disc radius may differ.
RENDER_SHARE_TOL = 1e-3
# Backward kernels against the plain backward: max-abs error <= BWD_REL_TOL
# * max|plain gradient|, 2 to 4 bf16 ulps of the largest gradient: the
# kernels round P to bf16 for P^T dO (the plain version keeps it fp32, as
# the Pallas kernel does), a few fp32 ulps of S can move a bf16 rounding of
# dS, and the sums run in another order.
BWD_REL_TOL = 2.0 ** -5
# Trainable gradients through the kernels against the plain versions: per
# group, |g_kernels - g_plain|_2 <= GRAD_TOL * |g_plain|_2, and per leaf the
# same with LEAF_TOL. Both runs are bf16 through the VAE, the UNet and three
# ControlNet trunks and round at other places in every attention and conv:
# on the H100 the groups differed by 2.1e-3 to 3.6e-3 and the worst leaf (a
# mid-block adapter with 0.1% of its group's norm) by 3.1e-2. A fault that
# drops one path of a leaf's gradient is off by order 1 on that leaf but
# can hide in its group's norm: with dq set to 0 the to_q adapters of the
# long attentions were off by 1.0 and the groups by 2.8e-2 to 5.8e-2. The
# check plants that fault once and fails unless it is rejected.
GRAD_TOL = 0.02
LEAF_TOL = 0.25


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS, exps: float = 0.0):
    """The least time for the work, in ms, and what sets it: the flops at
    `peak`, the bytes at the memory rate, or the exponentials at the SFU's
    rate ("exp"), whichever takes longest."""
    times = {"operations": flops / peak, "bytes": nbytes / PEAK_BYTES,
             "exp": exps / PEAK_EXP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def time_ms(fn, iters: int = 10, warmup: int = 2, queue_ahead: bool = True,
            sleep_cycles: int = 10_000_000) -> float:
    """Milliseconds per call from CUDA events around `iters` back-to-back
    calls. With queue_ahead the calls are queued behind a sleep kernel of
    `sleep_cycles` clocks (about 5 ms by default), so the events time the
    card alone as long as the host queues every call within the sleep;
    without it, a call whose host work (Python wrappers, launches) outlasts
    its device work is timed at the host's rate, as a caller issuing the
    calls back to back sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them: every
    time in this run is read beside them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi could not report the card's name and power limit ({e})")
    if not out:
        fail("nvidia-smi listed no card")
    return out[0]


# ---------------------------------------------------------------- kernels
# (BH, N, D) at micro-batch 2 (or B=1 with its guidance pair): the UNet and
# the lora_0 trunk run 2 x 8 heads, the lora_1 trunk (branches 2 and 4
# batched) 4 x 8, the static trunk (three branches) 6 x 8; N, D are 4096, 40
# and 1024, 80.
FLASH_SHAPES = [(bh, n, d) for bh in (2 * 8, 4 * 8, 6 * 8) for n, d in ((4096, 40), (1024, 80))]
# The serving knobs' shapes (serving phase): ToMe 0.5 merges the 64x64
# level's 4096 tokens to 2048 (UNet and the three trunks), a CFG-off step
# runs the UNet at B=1 (8 heads of 4096), and ToMe 0.3 leaves 4096 - 1228 =
# 2868 tokens, off the kernel's 128-key tile grid (a masked last tile).
FLASH_SERVING_SHAPES = [(16, 2048, 40), (32, 2048, 40), (48, 2048, 40), (8, 4096, 40),
                        (16, 4096 - int(0.3 * 4096), 40)]
# The DP x TP train step's per-rank shapes (multicard (c): one row a data
# rank, 8 / 2 heads a model rank): the UNet and the lora_0 trunk BH=4, the
# lora_1 trunk 8, the static trunk 12 (the forward); the UNet's up blocks
# and the LoRA trunks, 4 and 8 (the backward). (8, 4096, 40) is timed
# above with the serving shapes.
FLASH_DPTP_SHAPES = [(4, 4096, 40), (12, 4096, 40), (4, 1024, 80), (8, 1024, 80),
                     (12, 1024, 80)]
FLASH_BWD_DPTP_SHAPES = [(bh, n, d) for bh in (4, 8) for n, d in ((4096, 40), (1024, 80))]
# Checked, not timed: a ragged last key tile, and the widest and narrowest
# head dims the dispatch rule sends to the kernel.
FLASH_CHECK_SHAPES = [(2, 1000, 40), (2, 1024, 128), (2, 1024, 8)]
# Backward: the UNet's up blocks and the two LoRA trunks (the static trunk
# is frozen).
FLASH_BWD_SHAPES = [(bh, n, d) for bh in (2 * 8, 4 * 8) for n, d in ((4096, 40), (1024, 80))]
# Checked, not timed: a ragged last tile, and the widest and narrowest head
# dims.
FLASH_BWD_CHECK_SHAPES = [(2, 1000, 64), (2, 1024, 128), (2, 1024, 8)]
CONV_SHAPES = [  # (B, Cin, H, W, Cout, x dtype)
    (2, 320, 64, 64, 320, torch.bfloat16),
    (2, 1920, 32, 32, 640, torch.bfloat16),
    (2, 1280, 8, 8, 1280, torch.bfloat16),
    (1, 128, 512, 512, 128, torch.bfloat16),
    # conv1 of down block 0's ResNet blocks in the LoRA trunks at B=1 (the
    # lora_0 and lora_1 trunks): x = conv_in(sample) + the fp32 VAE-branch
    # embedding stays fp32 until the first downsampler
    (2, 320, 64, 64, 320, torch.float32),
    (4, 320, 64, 64, 320, torch.float32),
]
# The GN statistics at the bf16 conv shapes, and at (2, 320, 64, 64) with
# channel means of +40: fp32 (where the two-pass variance matters) and bf16
# (where the single-pass one cancels).
GN_SHAPES = [(b, c, h, w, dt, 0.0) for b, c, h, w, _, dt in CONV_SHAPES[:4]] + [
    (2, 320, 64, 64, torch.float32, 40.0), (2, 320, 64, 64, torch.bfloat16, 40.0)]


def kernel_phase(dev):
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.ops import flash, fused_conv

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = []

    shapes = []
    for bh, n, d in FLASH_SHAPES + FLASH_SERVING_SHAPES + FLASH_DPTP_SHAPES + FLASH_CHECK_SHAPES:
        q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        err, tol, lse_err = flash_check(q, k, v, scale)
        what = (f"flash_fwd BH={bh} N={n} D={d}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                f"lse_err={lse_err:.3e} (tol {LSE_TOL})")
        if not (err <= tol and lse_err <= LSE_TOL):
            print(what, flush=True)
            fail(f"flash_fwd disagrees with its plain version at {(bh, n, d)}")
        if (bh, n, d) in FLASH_CHECK_SHAPES:
            print(f"{what} (checked, not timed)", flush=True)
            continue
        ms = time_ms(lambda: flash.flash_attention_cuda(q, k, v, scale))
        plain_ms = time_ms(lambda: flash.flash_attention_reference(q, k, v, scale), iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        b_ms, b_by = flash_bound_ms(bh, n, d)
        print(f"{what} ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        shapes.append(dict(shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("flash_fwd", "edgestyle_tpu_torch/kernels/flash_fwd.cu",
                    "edgestyle_tpu/ops/flash.py:42", shapes))

    records.append(gn_phase(dev, gen))
    shapes = []
    for b, cin, h, w, cout, dt in CONV_SHAPES:
        x = torch.randn((b, cin, h, w), generator=gen, device=dev)
        if dt == torch.float32:
            x = x + 40.0
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn((cin,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((cin,), generator=gen, device=dev)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              / math.sqrt(9 * cin)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bias = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(torch.bfloat16)
        eps = 1e-6 if h == 512 else 1e-5
        s, t = fused_conv.gn_scale_shift(x, gamma, beta, 32, eps)
        out = fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias)
        torch.cuda.synchronize()
        ref = fused_conv.norm_act_conv3x3_reference(x, gamma, beta, wt, bias, 32, eps,
                                                    torch.bfloat16)
        err = (out.float() - ref.float()).abs().max().item()
        tol = REL_TOL * ref.float().abs().max().item()
        # ms: the kernel alone, on precomputed s, t; op_ms: the op the main
        # path calls (GN statistics kernel + conv kernel), like for like
        # with plain_ms; op_wall_ms: the op called back to back, host
        # included, as a caller issuing it from Python sees it
        ms = time_ms(lambda: fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, bias))
        op = lambda: fused_conv.norm_act_conv3x3(  # noqa: E731
            x, gamma, beta, wt, bias, num_groups=32, eps=eps, dtype=torch.bfloat16)
        op_ms = time_ms(op)
        op_wall_ms = time_ms(op, queue_ahead=False)
        plain_ms = time_ms(lambda: fused_conv.norm_act_conv3x3_reference(
            x, gamma, beta, wt, bias, 32, eps, torch.bfloat16))
        act = F.silu(x.float() * s[:, :, None, None] + t[:, :, None, None]).to(torch.bfloat16)
        act = act.contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(lambda: F.conv2d(act, wt, bias, padding=1))
        flops = 2.0 * b * h * w * 9 * cin * cout
        nbytes = b * h * w * cin * x.element_size() + 2 * b * cin * 4 + 9 * cin * cout * 2 \
            + cout * 2 + b * h * w * cout * 2
        b_ms, b_by = bound_ms(flops, nbytes)
        splits = fused_conv.conv_plan(b, h, w, cin, cout)[4]
        print(f"fused_gn_silu_conv3x3 x=({b},{cin},{h},{w}) {str(dt)[6:]} -> {cout} "
              f"(splits {splits}): max_abs_err={err:.3e} (tol {tol:.3e}; mean |ref| "
              f"{ref.float().abs().mean().item():.3e}) ms={ms:.4f} op_ms={op_ms:.4f} "
              f"op_wall_ms={op_wall_ms:.4f} plain_ms={plain_ms:.4f} conv2d_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
        if not err <= tol:
            fail(f"fused conv disagrees with its plain version at {(b, cin, h, w, cout, dt)}")
        shapes.append(dict(shape=[b, cin, h, w, cout], x_dtype=str(dt)[6:], splits=splits,
                           max_abs_err=err, ms=ms, op_ms=op_ms, op_wall_ms=op_wall_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records.append(("fused_gn_silu_conv3x3", "edgestyle_tpu_torch/kernels/fused_conv.cu",
                    "edgestyle_tpu/ops/fused_conv.py:88", shapes))
    for dt in (torch.bfloat16, torch.float32):
        activation_check(dev, gen, dt)
    records += flash_bwd_phase(dev, gen)
    # launches made for the comparison do not count
    kernels.reset_launches()
    return records


def flash_bound_ms(bh: int, n: int, d: int):
    """The flash forward's bound: q, k, v read and o, lse written once;
    4*N*N*D tensor-core flops and N*N exponentials per head."""
    return bound_ms(4.0 * bh * n * n * d, 4 * bh * n * d * 2 + bh * n * 4,
                    exps=float(bh) * n * n)


def flash_check(q, k, v, scale: float, fwd=None):
    """The flash forward kernel (or `fwd`, a function of the same
    arguments) against its plain version: (max-abs error of the output, its
    tolerance REL_TOL * max |plain output|, max-abs error of lse)."""
    from edgestyle_tpu_torch.ops import flash

    out, lse = (fwd or flash.flash_attention_cuda)(q, k, v, scale)
    torch.cuda.synchronize()
    ref = flash.flash_attention_reference(q, k, v, scale)
    ref_lse = flash.flash_attention_reference_lse(q, k, scale)
    err = (out.float() - ref.float()).abs().max().item()
    tol = REL_TOL * ref.float().abs().max().item()
    return err, tol, (lse.reshape(ref_lse.shape) - ref_lse).abs().max().item()


def gn_phase(dev, gen):
    """The GN statistics kernel against the plain statistics (the
    composition of torch reductions it replaces), with one torch.var_mean
    over the grouped view as the library yardstick. The tolerance is
    GN_REL_TOL, loosened for bf16 x by the single-pass cancellation."""
    from edgestyle_tpu_torch.ops import fused_conv

    shapes = []
    for b, c, h, w, dt, mean in GN_SHAPES:
        x = (mean + torch.randn((b, c, h, w), generator=gen, device=dev)
             + 0.5 * torch.randn((1, c, 1, 1), generator=gen, device=dev))
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        eps = 1e-6 if h == 512 else 1e-5
        s, t = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
        torch.cuda.synchronize()
        rs, rt = fused_conv.gn_scale_shift_reference(x, gamma, beta, 32, eps)
        grouped = x.permute(0, 2, 3, 1).reshape(b, h * w, 32, c // 32)
        var, mu = torch.var_mean(grouped.float(), dim=(1, 3), correction=0)
        ratio = (mu.square() / var).repeat_interleave(c // 32, dim=1)
        rtol = GN_REL_TOL + (GN_CANCEL_TOL * ratio if dt == torch.bfloat16 else 0.0)
        mean_s = (mu.repeat_interleave(c // 32, dim=1) * rs).abs()
        s_err = ((s - rs).abs() / (rtol * rs.abs())).max().item()
        t_err = ((t - rt).abs() / (rtol * mean_s + 1e-5)).max().item()
        err = max((s - rs).abs().max().item(), (t - rt).abs().max().item())
        again = fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps)
        same = torch.equal(again[0], s) and torch.equal(again[1], t)
        ms = time_ms(lambda: fused_conv.gn_scale_shift_cuda(x, gamma, beta, 32, eps))
        plain_ms = time_ms(lambda: fused_conv.gn_scale_shift_reference(x, gamma, beta, 32, eps))
        lib_ms = time_ms(lambda: torch.var_mean(grouped, dim=(1, 3)))
        n = x.numel()
        b_ms, b_by = bound_ms(3.0 * n, n * x.element_size() + 2 * c * 4 + 2 * b * c * 4,
                              PEAK_FP32_FLOPS)
        print(f"gn_scale_shift x=({b},{c},{h},{w}) {str(dt)[6:]} mean {mean}: max_abs_err="
              f"{err:.3e}, worst error / tolerance: s {s_err:.3f}, t {t_err:.3f} (tol 1; rtol "
              f"{GN_REL_TOL} + {GN_CANCEL_TOL if dt == torch.bfloat16 else 0} * mean^2/var, "
              f"max ratio {ratio.max().item():.1f}); deterministic {same}; ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} var_mean_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)
        if not (s_err <= 1 and t_err <= 1 and same):
            fail(f"gn_scale_shift disagrees with the plain statistics at {(b, c, h, w, dt)}")
        shapes.append(dict(shape=[b, c, h, w], x_dtype=str(dt)[6:], mean=mean, max_abs_err=err,
                           ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms))
    return ("gn_scale_shift", "edgestyle_tpu_torch/kernels/gn_stats.cu",
            "edgestyle_tpu/ops/fused_conv.py:50", shapes)


def flash_bwd_bound_ms(bh: int, n: int, d: int, products: int):
    """A flash backward kernel's bound: q, k, v, dO, lse and D read once and
    its `products` N x N x D products' outputs ((B, H, N, D) bf16 each: dq,
    or dk and dv) written once; 2*N*N*D tensor-core flops a product and N*N
    exponentials per head (P is recomputed)."""
    outs = 1 if products == 3 else 2
    nbytes = 4 * bh * n * d * 2 + 2 * bh * n * 4 + outs * bh * n * d * 2
    return bound_ms(2.0 * products * bh * n * n * d, nbytes, exps=float(bh) * n * n)


def flash_bwd_inputs(gen, dev, bh: int, n: int, d: int):
    """(q, k, v, dO, lse, D, scale) at (1, BH, N, D) bf16, lse and D from the
    forward kernel's own output."""
    from edgestyle_tpu_torch.ops import flash

    q, k, v, do = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_attention_cuda(q, k, v, scale)
    return q, k, v, do, lse, flash.flash_bwd_delta(out, do), scale


def flash_bwd_errors(args, dq_fn=None, dkv_fn=None):
    """The backward kernels (or dq_fn / dkv_fn, functions of the same
    arguments) against their plain versions: {name: (max-abs error,
    tolerance BWD_REL_TOL * max |plain|, max |plain|)} for dq, dk and dv;
    a name whose function is False is left out."""
    from edgestyle_tpu_torch.ops import flash

    got, ref = {}, {}
    if dq_fn is not False:
        got["dq"] = (dq_fn or flash.flash_bwd_dq_cuda)(*args)
    if dkv_fn is not False:
        got["dk"], got["dv"] = (dkv_fn or flash.flash_bwd_dkv_cuda)(*args)
    torch.cuda.synchronize()
    if "dq" in got:
        ref["dq"] = flash.flash_bwd_dq_reference(*args)
    if "dk" in got:
        ref["dk"], ref["dv"] = flash.flash_bwd_dkv_reference(*args)
    errs = {}
    for name, r in ref.items():
        rmax = r.float().abs().max().item()
        errs[name] = ((got[name].float() - r.float()).abs().max().item(), BWD_REL_TOL * rmax,
                      rmax)
    return errs


def flash_bwd_phase(dev, gen):
    """Both backward kernels against their plain versions on the forward's
    own output and lse, at the training step's shapes (timed) and at
    FLASH_BWD_CHECK_SHAPES (checked only). The library yardstick is the
    backward of F.scaled_dot_product_attention (dq, dk and dv together),
    for each of the two."""
    from edgestyle_tpu_torch.ops import flash

    dq_shapes, dkv_shapes = [], []
    for bh, n, d in FLASH_BWD_SHAPES + FLASH_BWD_DPTP_SHAPES + FLASH_BWD_CHECK_SHAPES:
        args = flash_bwd_inputs(gen, dev, bh, n, d)
        errs = flash_bwd_errors(args)
        err_txt = ", ".join(f"{k} max_abs_err={e:.3e} (tol {t:.3e}; max |ref| {m:.3e})"
                            for k, (e, t, m) in errs.items())
        if not all(e <= t for e, t, _ in errs.values()):
            print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt}", flush=True)
            fail(f"the flash backward kernels disagree with their plain versions at "
                 f"{(bh, n, d)}")
        if (bh, n, d) in FLASH_BWD_CHECK_SHAPES:
            print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt} (checked, not timed)", flush=True)
            continue
        ms_dq = time_ms(lambda: flash.flash_bwd_dq_cuda(*args))
        ms_dkv = time_ms(lambda: flash.flash_bwd_dkv_cuda(*args))
        plain_dq = time_ms(lambda: flash.flash_bwd_dq_reference(*args), iters=3, warmup=1)
        plain_dkv = time_ms(lambda: flash.flash_bwd_dkv_reference(*args), iters=3, warmup=1)
        lib_ms = sdpa_backward_ms(*args[:4])
        b_dq = flash_bwd_bound_ms(bh, n, d, 3)
        b_dkv = flash_bwd_bound_ms(bh, n, d, 4)
        print(f"flash_bwd BH={bh} N={n} D={d}: {err_txt}; dq ms={ms_dq:.4f} "
              f"plain_ms={plain_dq:.4f} bound_ms={b_dq[0]:.4f} ({b_dq[1]}); dkv ms={ms_dkv:.4f} "
              f"plain_ms={plain_dkv:.4f} bound_ms={b_dkv[0]:.4f} ({b_dkv[1]}); "
              f"sdpa_backward_ms={lib_ms:.4f}", flush=True)
        dq_shapes.append(dict(shape=[bh, n, d], max_abs_err=errs["dq"][0], ms=ms_dq,
                              plain_ms=plain_dq, bound_ms=b_dq[0], bound_by=b_dq[1],
                              library_ms=lib_ms))
        dkv_shapes.append(dict(shape=[bh, n, d], max_abs_err=max(errs["dk"][0], errs["dv"][0]),
                               ms=ms_dkv, plain_ms=plain_dkv, bound_ms=b_dkv[0],
                               bound_by=b_dkv[1], library_ms=lib_ms))
    return [("flash_bwd_dq", "edgestyle_tpu_torch/kernels/flash_bwd.cu",
             "edgestyle_tpu/ops/flash.py:141", dq_shapes),
            ("flash_bwd_dkv", "edgestyle_tpu_torch/kernels/flash_bwd.cu",
             "edgestyle_tpu/ops/flash.py:175", dkv_shapes)]


def sdpa_backward_ms(q, k, v, do, readings: int = 5) -> float:
    """One backward of F.scaled_dot_product_attention (dq, dk and dv
    together) on the same inputs, the library yardstick of both backward
    kernels: the median of `readings` timings. torch.autograd.grad returns
    the gradients without adding them into .grad, and each timing's calls
    queue behind a sleep of about 50 ms, which outlasts the host's autograd
    work for all of them."""
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl)

    def backward():
        torch.autograd.grad(out, (ql, kl, vl), do, retain_graph=True)

    return statistics.median(time_ms(backward, sleep_cycles=100_000_000)
                             for _ in range(readings))


def bf16_order(a: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in value order: neighbours differ by 1."""
    i = a.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def activation_check(dev, gen, dtype) -> None:
    """The fused conv's bf16 activations against bf16(exact silu) of x in
    dtype: with an identity centre-tap weight and zero bias, each output is
    one activation times 1 plus zeros, so the kernel writes its activation
    unchanged. Pre-activations ~N(-1, 2.7) reach the negative range where
    silu is a small difference."""
    from edgestyle_tpu_torch.ops import fused_conv

    b, c, h, w = 2, 320, 64, 64
    x = torch.randn((b, c, h, w), generator=gen, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    s = 2.5 * (1.0 + 0.1 * torch.randn((b, c), generator=gen, device=dev))
    t = torch.randn((b, c), generator=gen, device=dev) - 1.0
    wt = torch.zeros((c, c, 3, 3), device=dev)
    wt[torch.arange(c), torch.arange(c), 1, 1] = 1.0
    wt = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = fused_conv.fused_gn_silu_conv3x3(x, s, t, wt, torch.zeros(c, device=dev))
    a = (x.double() * s.double()[:, :, None, None] + t.double()[:, :, None, None]).float()
    a = a.double()
    ref = (a * torch.sigmoid(a)).to(torch.bfloat16)
    ulps = (bf16_order(out) - bf16_order(ref)).abs()
    share = (ulps > 0).double().mean().item()
    print(f"fused conv activations vs bf16(exact silu), {str(dtype)[6:]} x, {ulps.numel()} "
          f"values, "
          f"pre-activation in [{a.min().item():.2f}, {a.max().item():.2f}]: "
          f"share rounded otherwise {share:.3e} (tol {ACT_SHARE_TOL}), "
          f"max {ulps.max().item()} bf16 ulps (tol 1)", flush=True)
    if not (share <= ACT_SHARE_TOL and ulps.max().item() <= 1):
        fail(f"the fused conv's activations stray from bf16(silu) on {dtype} x")


# ------------------------------------------------------------- generation
def build_pipeline(dev):
    """Full-width bf16 SD1.5 6-branch pipeline from the port's random init,
    with the zero-init ControlNet heads and cond-embedding conv_out set to
    small random values so every branch (and both kernels in its trunk)
    moves the image."""
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig

    pipe = EdgeStylePipeline(PipelineConfig(), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = pipe.init_params(gen)

    def small(tree, std_scale):
        w = tree["kernel"]
        fan_in = math.prod(w.shape[1:])
        kernel = torch.randn(w.shape, generator=gen, device=dev) * (std_scale / math.sqrt(fan_in))
        return {"kernel": kernel.to(w.dtype).contiguous(memory_format=torch.channels_last),
                "bias": torch.zeros_like(tree["bias"])}

    for key in ("static", "lora_0", "lora_1"):
        tree = params["controlnet"][key]
        for name in [k for k in tree if k.startswith("controlnet_down_blocks_")
                     or k == "controlnet_mid_block"]:
            tree[name] = small(tree[name], 0.3)
    emb = params["controlnet"]["static"]["controlnet_cond_embedding"]
    emb["conv_out"] = small(emb["conv_out"], 1.0)
    return pipe, params, gen


def make_request(gen, dev, b: int, n_branches: int, latent_branches):
    ids = torch.randint(1, 49407, (b, 77), generator=gen, device=dev)
    neg = torch.randint(1, 49407, (b, 77), generator=gen, device=dev)
    imgs = []
    for p in range(n_branches):
        im = torch.rand((b, 3, 512, 512), generator=gen, device=dev)
        imgs.append(im * 2 - 1 if p in latent_branches else im)  # VAE branches take [-1, 1]
    lat = torch.randn((b, 4, 64, 64), generator=gen, device=dev)
    return ids, neg, imgs, lat


def check_images(out, b: int, what: str) -> None:
    if tuple(out.shape) != (b, 3, 512, 512):
        fail(f"{what}: image shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite image values")
    lo, hi, std = out.min().item(), out.max().item(), out.float().std().item()
    if lo < 0 or hi > 1 or not std > 0:
        fail(f"{what}: image range [{lo}, {hi}] std {std}")


# Launches per generation (any batch), from the code at SD1.5 width, 512 px,
# 20 steps: flash_fwd at the 22 self-attentions with >= 1024 tokens per
# denoise step (the UNet's 10, 4 in each of the 3 trunks); one GN statistics
# and one conv launch per fused conv: 104 a step (2 per ResNet block: the
# UNet's 22 and each trunk's 10), plus the VAE's 48 (encoder 10 blocks for
# the three VAE conds in one batch, decoder 14).
GEN_STEPS = 20
GEN_LAUNCHES_PER_REQUEST = {"flash_fwd": 22 * GEN_STEPS,
                            "gn_scale_shift": 104 * GEN_STEPS + 2 * (10 + 14),
                            "fused_gn_silu_conv3x3": 104 * GEN_STEPS + 2 * (10 + 14),
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def generation_phase(dev, pipe, params, gen):
    from edgestyle_tpu_torch import kernels

    cfg = pipe.cfg
    # warm-up (lazy library loads, cuBLAS/cuDNN plans): not a counted request
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    t0 = time.perf_counter()
    out = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    torch.cuda.synchronize()
    print(f"warm-up request (B=1, 2 steps): {time.perf_counter() - t0:.3f} s", flush=True)

    requests = [
        ("B=1 guidance 3.5", 1, 3.5),
        ("B=2 per-sample guidance [3.5, 7.5]", 2, [3.5, 7.5]),
        ("B=1 guidance 5.0", 1, 5.0),
    ]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for what, b, g in requests:
        ids, neg, imgs, lat = make_request(gen, dev, b, cfg.num_branches, cfg.latent_branches)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=GEN_STEPS,
                   guidance_scale=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_images(out, b, what)
        per = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        print(f"request {what}, {GEN_STEPS} UniPC steps, 512 px: {dt:.3f} s, {b / dt:.4f} "
              f"images/s, image mean {out.mean().item():.4f} std {out.std().item():.4f}, "
              f"launches per generation {per}", flush=True)
        if per != GEN_LAUNCHES_PER_REQUEST:
            fail(f"the generation's kernel launches differ from the counts the code predicts "
                 f"{GEN_LAUNCHES_PER_REQUEST}")
    totals = dict(kernels.LAUNCHES)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return totals


def profile_phase(dev, pipe, params, gen, out_dir: str) -> None:
    """One B=1 20-step generation under torch.profiler: device time by
    kernel and the device's busy share of the wall time. The full table
    goes to ``out_dir/profile_b1.txt``."""
    cfg = pipe.cfg
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    rows, wall, busy = profiled(
        lambda: pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=20), out_dir,
        "profile_b1.txt")
    print(f"profile (B=1, 20 steps, profiler on): wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), idle share {100 * (1 - busy / wall):.1f}%, "
          f"{sum(r[1] for r in rows)} device launches", flush=True)
    _print_families(rows, busy)
    for ms, n, key in rows[:12]:
        print(f"  {ms:10.3f} ms {100 * ms / 1e3 / busy:5.1f}% {n:6d}x {key[:90]}", flush=True)


def e2e_phase(dev, pipe, params, gen):
    """2 steps through the kernels, then through the ops' plain versions
    (the layers' and attention's references swapped in here, not by any
    switch in the port), on the same weights, inputs and latents."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv

    cfg = pipe.cfg
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    out_k = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        before = dict(kernels.LAUNCHES)
        out_p = pipe(params, ids, neg, imgs, latents=lat, num_inference_steps=2)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != before:
            fail("the plain run launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    check_images(out_k, 1, "e2e kernels")
    check_images(out_p, 1, "e2e plain")
    diff = (out_k - out_p).abs()
    print(f"e2e kernels vs plain (2 steps, bf16): image max_abs_diff={diff.max().item():.4e} "
          f"mean_abs_diff={diff.mean().item():.4e} (tol {E2E_TOL})", flush=True)
    if not diff.max().item() <= E2E_TOL:
        fail("end-to-end images through the kernels and the plain versions disagree")


# ---------------------------------------------------------------- serving
# Launches of one request by the part of a denoise step that runs, from the
# code at SD1.5 width (GEN_LAUNCHES_PER_REQUEST is every step at full): the
# three trunk calls (4 self-attentions of >= 1024 tokens and 10 ResNet
# blocks each), the full UNet (10 and 22), shallow_forward (down block 0
# without its downsampler and the last up block: 5 and 5), and the VAE's 24
# ResNet blocks once. ToMe and CFG-off steps change no count: a merged 64x64
# level keeps 2048 (ratio 0.5) or 2868 (0.3) tokens, still >= 1024 (the
# flash rule), and a half-batch call launches each kernel once, as a full one.
STEP_PARTS = {"trunks": {"flash_fwd": 12, "conv": 2 * 30},
              "unet": {"flash_fwd": 10, "conv": 2 * 22},
              "shallow": {"flash_fwd": 5, "conv": 2 * 5}}
VAE_CONV_LAUNCHES = 2 * (10 + 14)
SERVING_STEPS = 20
ALL = tuple(range(SERVING_STEPS))
# name: (--mode or knob flags of apps/tryon.py, steps, the steps that run the
# trunks, the steps that run the full UNet): the refresh sets read from the
# presets (apps/tryon.py::SERVING_MODES) and the pipeline's rule that an
# interval k refreshes at 0, k, 2k, ...
SERVING_RUNS = {
    "exact": ([], SERVING_STEPS, ALL, ALL),
    "conservative": (["--mode", "conservative"], SERVING_STEPS, ALL, ALL),
    "quality": (["--mode", "quality"], SERVING_STEPS, tuple(range(0, 20, 2)), ALL),
    "aggressive": (["--mode", "aggressive"], SERVING_STEPS, (0, 1, 2, 4, 7, 11, 16), ALL),
    "turbo": (["--mode", "turbo"], SERVING_STEPS, tuple(range(0, 20, 3)), tuple(range(0, 20, 2))),
    "dpm++": (["--scheduler", "dpm++"], SERVING_STEPS, ALL, ALL),
    "lcm": (["--mode", "lcm"], 4, (0, 1, 2, 3), (0, 1, 2, 3)),
    "tome_0.3_off_grid": (["--tome", "0.3"], SERVING_STEPS, ALL, ALL),
}
SERVING_TIMED = 1
LCM_LORA_RANK = 64
# A cfg_interval (0, 0) generation (B rows, conditional context) against
# guidance 1.0 (2B rows, uncond + 1 * (cond - uncond)): the same function,
# through kernels at other batch sizes, whose bf16 sums round at other
# places: the end-to-end check's tolerance, at its depth (4 steps here).
CFG_OFF_TOL = E2E_TOL


def serving_launches(steps: int, trunk_steps, unet_steps) -> dict:
    """The kernels' predicted launches of one B=1 request."""
    flash = conv = 0
    for i in range(steps):
        parts = (["trunks"] if i in trunk_steps else []) + (
            ["unet"] if i in unet_steps else ["shallow"])
        flash += sum(STEP_PARTS[p]["flash_fwd"] for p in parts)
        conv += sum(STEP_PARTS[p]["conv"] for p in parts)
    conv += VAE_CONV_LAUNCHES
    return {"flash_fwd": flash, "gn_scale_shift": conv, "fused_gn_silu_conv3x3": conv,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def seeded_lcm_lora(unet_params, gen, rank: int):
    """Adapters over every attention, feed-forward and time-embedding linear
    of the whole UNet (the LCM-LoRA distiller's targets), the port's layout:
    down (rank, in) ~ N(0, 1/rank), up (out, rank) ~ N(0, 0.02^2), fp32."""
    from edgestyle_tpu_torch.core.params import flatten, unflatten
    from edgestyle_tpu_torch.models.unet import LORA_LINEAR_LEAF_NAMES

    lora = {}
    for path, leaf in flatten(unet_params).items():
        if (leaf.ndim == 2 and path[-1] == "kernel"
                and any(path[-2].startswith(n) for n in LORA_LINEAR_LEAF_NAMES)):
            dout, din = leaf.shape
            dev = leaf.device
            lora[path] = {
                "down": torch.randn((rank, din), generator=gen, device=dev) / rank,
                "up": 0.02 * torch.randn((dout, rank), generator=gen, device=dev)}
    return unflatten(lora)


def serving_phase(dev, pipe, params, gen, card: str, profile_dir=None):
    """The serving knobs at full width on the generation phase's params,
    512 px, B=1: each run is one warm-up and SERVING_TIMED timed requests of
    the same request through apps/tryon.py's presets and knob flags
    (apply_serving_mode, serving_kwargs) and the pipeline they ask for, with
    the kernels' launches against serving_launches; the image's max-abs
    difference from the exact image is printed, not held (random weights).
    Held: the knobs at their exact values give the exact image bit for bit;
    shallow_forward on a deep feature from the same (sample, t) equals the
    UNet's output bit for bit; cfg_interval (0, 0) against guidance 1.0 and
    turbo through the kernels against the ops' plain versions (4 steps)
    within E2E_TOL; ToMe's merge rows on the card equal the CPU's. With
    ``profile_dir``, one more request of each run under torch.profiler:
    device time, busy share and device launches
    (``profile_dir/profile_serving_<run>.txt``)."""
    import dataclasses

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import tryon
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv, tome
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
    from edgestyle_tpu_torch.training.distill import apply_lcm_lora

    exact_counts = serving_launches(SERVING_STEPS, ALL, ALL)
    if exact_counts != GEN_LAUNCHES_PER_REQUEST:
        fail(f"serving: the step parts {STEP_PARTS} do not add up to the generation's "
             f"counts {GEN_LAUNCHES_PER_REQUEST}")
    cfg = pipe.cfg
    req = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    rec, bad = {"card": card, "runs": {}}, []
    pipes = {}

    def pipe_for(scheduler: str, ratio: float):
        key = (scheduler, ratio)
        if key not in pipes:
            pipes[key] = EdgeStylePipeline(dataclasses.replace(cfg, scheduler=scheduler),
                                           device=dev, tome=ratio)
        return pipes[key]

    lcm_params = dict(params, unet=apply_lcm_lora(
        params["unet"], seeded_lcm_lora(params["unet"], gen, LCM_LORA_RANK)))
    totals = {k: 0 for k in kernels.LAUNCHES}
    exact_img = None
    for name, (flags, steps, trunk_steps, unet_steps) in SERVING_RUNS.items():
        args = tryon.apply_serving_mode(tryon.parse_args(
            ["--subject", "s", "--clothes1", "a", "--clothes2", "b", "--random_init"] + flags))
        if args.steps != steps:
            fail(f"serving {name}: the preset asks for {args.steps} steps, the run for {steps}")
        knobs = tryon.serving_kwargs(args)
        run_pipe = pipe_for(args.scheduler, float(args.tome))
        run_params = lcm_params if args.scheduler == "lcm" else params

        def request():
            return run_pipe(run_params, *req[:3], latents=req[3], num_inference_steps=steps,
                            generator=torch.Generator(device=dev).manual_seed(0), **knobs)

        request()  # warm-up
        kernels.reset_launches()
        walls, images = [], []
        for _ in range(SERVING_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images.append(request())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        img = images[-1]
        per = {k: v / SERVING_TIMED for k, v in kernels.LAUNCHES.items()}
        for k, v in kernels.LAUNCHES.items():
            totals[k] += v
        kernels.reset_launches()
        prof = None
        if profile_dir:
            rows, wall, busy = profiled(request, profile_dir, f"profile_serving_{name}.txt")
            prof = dict(wall_s=wall, device_s=busy, busy_share=busy / wall,
                        device_launches=sum(r[1] for r in rows), families=_families(rows))
        check_images(img, 1, f"serving {name}")
        want = serving_launches(steps, trunk_steps, unet_steps)
        if name == "exact":
            exact_img = img
        diff = (img - exact_img).abs().max().item()
        rec["runs"][name] = dict(flags=flags, steps=steps, scheduler=args.scheduler,
                                 tome=float(args.tome), knobs={k: list(v) if isinstance(
                                     v, tuple) else v for k, v in knobs.items()},
                                 wall_s=walls, wall_s_median=statistics.median(walls),
                                 launches_per_request=per, predicted=want,
                                 max_abs_diff_from_exact=diff,
                                 repeats_equal_bitwise=all(torch.equal(i, img) for i in images),
                                 profiled=prof,
                                 image_mean=img.mean().item(), image_std=img.std().item())
        print(f"serving {name} ({' '.join(flags) or 'exact'}: {args.scheduler}, tome "
              f"{float(args.tome)}, {steps} steps, knobs {knobs}): wall "
              f"{', '.join(f'{w:.3f}' for w in walls)} s (median "
              f"{statistics.median(walls):.3f}); launches per request flash_fwd "
              f"{per['flash_fwd']:g} (predicted {want['flash_fwd']}), gn_scale_shift "
              f"{per['gn_scale_shift']:g}, fused_gn_silu_conv3x3 "
              f"{per['fused_gn_silu_conv3x3']:g} (predicted {want['fused_gn_silu_conv3x3']}); "
              f"max |image - exact| {diff:.4f} (printed, not held); repeats bit for bit "
              f"{rec['runs'][name]['repeats_equal_bitwise']}", flush=True)
        if prof:
            print(f"  profiled (profiler on): wall {prof['wall_s']:.3f} s, device busy "
                  f"{prof['device_s']:.3f} s ({100 * prof['busy_share']:.1f}%), "
                  f"{prof['device_launches']} device launches; by family: "
                  f"{prof['families']}", flush=True)
        if per != {k: float(v) for k, v in want.items()}:
            bad.append(f"{name}: launches {per} against the prediction {want}")

    # the knobs at their exact values: the exact program, the exact image
    knob_pipe = pipe_for("unipc", 0.0)
    same = knob_pipe(params, *req[:3], latents=req[3], num_inference_steps=SERVING_STEPS,
                     controlnet_cache_interval=1, unet_cache_interval=1, cfg_interval=(0.0, 1.0),
                     controlnet_cache_steps=ALL, unet_cache_steps=ALL)
    rec["exact_knobs_equal_bitwise"] = bool(torch.equal(same, exact_img))
    if not rec["exact_knobs_equal_bitwise"]:
        bad.append(f"the exact knob values moved the image by "
                   f"{(same - exact_img).abs().max().item():.3e}")

    # shallow_forward on the deep feature of the same (sample, t)
    with torch.no_grad():
        g2 = torch.Generator(device=dev).manual_seed(1)
        unet = pipe.unet
        x2 = torch.cat([req[3], req[3]]).contiguous(memory_format=torch.channels_last)
        t2 = torch.full((2,), 499, dtype=torch.long, device=dev)
        ctx = torch.randn((2, cfg.clip.max_positions, cfg.clip.hidden_size), generator=g2,
                          device=dev).to(pipe.dtype)
        # the skips' sizes: conv_in's, then each block's, halved after each downsampler
        hw, sizes = x2.shape[-1], [x2.shape[-1]]
        for i in range(len(cfg.unet.block_out_channels)):
            sizes += [hw] * cfg.unet.layers_per_block
            if i < len(cfg.unet.block_out_channels) - 1:
                hw //= 2
                sizes.append(hw)
        def noise(c, s):
            x = 0.1 * torch.randn((2, c, s, s), generator=g2, device=dev)
            return x.to(pipe.dtype).contiguous(memory_format=torch.channels_last)

        down = [noise(c, s) for c, s in zip(unet.skip_channels(), sizes)]
        mid = noise(cfg.unet.block_out_channels[-1], hw)
        out, deep = unet(params["unet"], x2, t2, ctx, down_block_additional_residuals=down,
                         mid_block_additional_residual=mid, return_deep=True)
        shallow = unet.shallow_forward(params["unet"], x2, t2, ctx, deep,
                                       down_block_additional_residuals=down)
        rec["shallow_forward_equal_bitwise"] = bool(torch.equal(shallow, out))
        rec["shallow_forward_max_abs_diff"] = (shallow - out).abs().max().item()
        if not rec["shallow_forward_equal_bitwise"]:
            bad.append(f"shallow_forward differs from the UNet by "
                       f"{rec['shallow_forward_max_abs_diff']:.3e} at the same (sample, t)")

    # CFG off against guidance 1.0, 4 steps
    off = pipe(params, *req[:3], latents=req[3], num_inference_steps=4, cfg_interval=(0.0, 0.0))
    g1 = pipe(params, *req[:3], latents=req[3], num_inference_steps=4, guidance_scale=1.0)
    rec["cfg_off_vs_guidance_1_max_abs_diff"] = (off - g1).abs().max().item()
    if not rec["cfg_off_vs_guidance_1_max_abs_diff"] <= CFG_OFF_TOL:
        bad.append(f"cfg_interval (0, 0) is {rec['cfg_off_vs_guidance_1_max_abs_diff']:.3e} "
                   f"off guidance 1.0 (tol {CFG_OFF_TOL})")

    # turbo through the kernels against the ops' plain versions, 4 steps
    turbo = tryon.apply_serving_mode(tryon.parse_args(
        ["--subject", "s", "--clothes1", "a", "--clothes2", "b", "--mode", "turbo"]))
    turbo_pipe, turbo_kw = pipe_for("unipc", float(turbo.tome)), tryon.serving_kwargs(turbo)
    out_k = turbo_pipe(params, *req[:3], latents=req[3], num_inference_steps=4, **turbo_kw)
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        before = dict(kernels.LAUNCHES)
        out_p = turbo_pipe(params, *req[:3], latents=req[3], num_inference_steps=4, **turbo_kw)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != before:
            fail("serving: the plain turbo run launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    kernels.reset_launches()
    check_images(out_k, 1, "serving turbo kernels")
    check_images(out_p, 1, "serving turbo plain")
    rec["turbo_kernels_vs_plain_max_abs_diff"] = (out_k - out_p).abs().max().item()
    if not rec["turbo_kernels_vs_plain_max_abs_diff"] <= E2E_TOL:
        bad.append(f"turbo through the kernels is "
                   f"{rec['turbo_kernels_vs_plain_max_abs_diff']:.3e} off the plain versions "
                   f"(tol {E2E_TOL})")

    # ToMe's ranking on the card against the CPU, full-width bf16 metrics
    g3 = torch.Generator(device=dev).manual_seed(2)
    rows_equal = {}
    for ratio in (0.5, 0.3):
        metric = torch.randn((2, 4096, 320), generator=g3, device=dev).to(torch.bfloat16)
        r = int(ratio * 4096)
        rows = []
        for d in (dev, torch.device("cpu")):
            _, unmerge, r_eff = tome.build_merge(metric.to(d), 64, 64, r)
            ids = torch.arange(4096 - r_eff, dtype=torch.float32, device=d)
            rows.append(unmerge(ids[None, :, None].expand(2, -1, 1)).cpu())
        rows_equal[str(ratio)] = bool(torch.equal(*rows))
        if not rows_equal[str(ratio)]:
            bad.append(f"ToMe {ratio}: the merge rows on the card differ from the CPU's")
    rec["tome_rows_card_equal_cpu"] = rows_equal
    rec["launches_total"] = totals

    print(f"serving checks ({card}): exact knob values bit for bit "
          f"{rec['exact_knobs_equal_bitwise']}; shallow_forward vs UNet at the same (sample, "
          f"t) bit for bit {rec['shallow_forward_equal_bitwise']} (max "
          f"{rec['shallow_forward_max_abs_diff']:.3e}); cfg_interval (0, 0) vs guidance 1.0 "
          f"(4 steps) max_abs_diff {rec['cfg_off_vs_guidance_1_max_abs_diff']:.4e} (tol "
          f"{CFG_OFF_TOL}); turbo kernels vs plain (4 steps) max_abs_diff "
          f"{rec['turbo_kernels_vs_plain_max_abs_diff']:.4e} (tol {E2E_TOL}); ToMe rows card "
          f"== CPU {rows_equal}", flush=True)
    print(json.dumps({"serving": rec}), flush=True)
    if bad:
        fail("serving: " + "; ".join(bad))
    return totals


# ------------------------------------------------------------------ int8
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate, the same data sheet
# The int8 op check: the denoise step's hot int8 products at B=1 with its
# guidance pair (the static trunk's three branches: 6 rows).
# (name, B, Cin, H, W, Cout, kernel, stride) for convs.
INT8_CONV_SHAPES = [
    ("resnet 6x320x64x64->320", 6, 320, 64, 64, 320, 3, 1),
    ("up-block concat 6x960x64x64->320", 6, 960, 64, 64, 320, 3, 1),
    ("mid 2x1280x8x8->1280", 2, 1280, 8, 8, 1280, 3, 1),
    ("downsample 6x320x64x64->320 stride 2", 6, 320, 64, 64, 320, 3, 2),
]
# (name, x shape, features) for Dense layers
INT8_DENSE_SHAPES = [("token 2x4096x320->320", (2, 4096, 320), 320),
                     ("cross-attention K 2x77x768->320", (2, 77, 768), 320)]
# int8 products of one denoise step at SD1.5 width (the code's structure:
# ops/quant.py COUNTS), with CFG: the UNet's 64 convs (22 ResNet blocks x 2,
# 14 shortcuts, 3 downsamplers, 3 upsamplers) and 192 Dense (16
# Transformer2Ds x 12: proj_in, proj_out, 8 attention projections, the
# GEGLU's two), and each of the 3 trunk calls' 38 convs (10 ResNet blocks x
# 2, 2 shortcuts, 3 downsamplers, 13 zero-conv heads) and 84 Dense.
INT8_PER_STEP = {"conv": 64 + 3 * 38, "dense": 192 + 3 * 84}
# Launches of an int8 generation: the flash forward as the exact program's;
# no GN statistics or fused conv inside the steps, only the VAE's 24 ResNet
# blocks (the encode of the three VAE conds and the decode).
INT8_LAUNCHES = {"flash_fwd": 22 * GEN_STEPS, "gn_scale_shift": VAE_CONV_LAUNCHES,
                 "fused_gn_silu_conv3x3": VAE_CONV_LAUNCHES, "flash_bwd_dq": 0,
                 "flash_bwd_dkv": 0}
INT8_WALL_REPS = 1


def _int8_conv_case(gen_cpu, b, cin, h, w, cout, k):
    x = torch.randn((b, cin, h, w), generator=gen_cpu).to(torch.bfloat16)
    kern = torch.randn((cout, cin, k, k), generator=gen_cpu) / math.sqrt(k * k * cin)
    bias = torch.randn((cout,), generator=gen_cpu).to(torch.bfloat16)
    return (x.contiguous(memory_format=torch.channels_last),
            kern.to(torch.bfloat16).contiguous(memory_format=torch.channels_last), bias)


def int8_op_check(dev, card: str) -> list:
    """The int8 route on the card against the plain route on the CPU at the
    denoise step's hot shapes: q and s of weight and activation, the int32
    accumulators and the dequantised outputs bit for bit (each is the same
    true division, round half to even, exact integer sum and fp32 epilogue
    on both), a planted fault of each kind rejected (one im2col tap shifted
    by a pixel; one weight scale one fp32 ulp off); and the times: the whole
    int8 op, ``torch._int_mm`` alone against its bound, the bf16 fused conv
    op (stride 1) and cuDNN's bf16 ``F.conv2d`` (``F.linear`` for a Dense)."""
    from edgestyle_tpu_torch.ops import fused_conv, quant

    gen_cpu = torch.Generator().manual_seed(11)
    cpu = torch.device("cpu")
    rows, bad = [], []

    def same(what, a, b):
        if not torch.equal(a.cpu(), b.cpu()):
            bad.append(f"{what}: card != plain route")

    for name, b, cin, h, w, cout, k, stride in INT8_CONV_SHAPES:
        x, kern, bias = _int8_conv_case(gen_cpu, b, cin, h, w, cout, k)
        got = []
        for d in (dev, cpu):
            qk = quant.quantize_params({"c": {"kernel": kern.to(d)}})["c"]["kernel"]
            qx, sx = quant.quantize_activation(x.to(d))
            acc = quant.conv_int32(qx, qk, stride, 1)
            got.append((qk, qx, sx, acc, quant.dequantize(acc, sx, qk.s, bias.to(d),
                                                          torch.bfloat16)))
        (qk, qx, sx, acc, out), (qk_c, qx_c, sx_c, acc_c, out_c) = got
        for what, a, p in (("weight q", qk.q, qk_c.q), ("weight s", qk.s, qk_c.s),
                           ("activation q", qx, qx_c), ("activation s", sx, sx_c),
                           ("int32 accumulator", acc, acc_c), ("output", out, out_c)):
            same(f"{name} {what}", a, p)
        err = (out.float().cpu() - out_c.float()).abs().max().item()
        # planted faults: one im2col tap shifted by a pixel; one scale an ulp off
        cols, ho, wo = quant.im2col(qx, k, k, stride, 1)
        tap = cols[:, :cin].reshape(b, ho, wo, cin).roll(1, dims=2).reshape(-1, cin)
        shifted = torch.cat([tap, cols[:, cin:]], dim=1)
        bad_acc = torch._int_mm(shifted, qk.matrix().t()).reshape(acc.shape)
        if torch.equal(bad_acc.cpu(), acc_c):
            bad.append(f"{name}: a shifted im2col tap went unnoticed")
        s_ulp = qk.s.clone()
        s_ulp[0] = torch.nextafter(s_ulp[0], torch.tensor(float("inf"), device=dev))
        if torch.equal(quant.dequantize(acc, sx, s_ulp, bias.to(dev), torch.float32).cpu(),
                       quant.dequantize(acc_c, sx_c, qk_c.s, bias, torch.float32)):
            bad.append(f"{name}: a weight scale one ulp off went unnoticed")
        # times
        xd, kd, bd = x.to(dev), kern.to(dev), bias.to(dev)
        wmat = qk.matrix()
        m, kk = cols.shape
        int_mm_bound, int_mm_by = bound_ms(2.0 * m * cout * kk, m * kk + kk * cout + 4 * m * cout,
                                           peak=PEAK_INT8_OPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        quant.quant_conv(xd, qk, bd, torch.bfloat16, stride, 1)
        torch.cuda.synchronize()
        row = dict(shape=name, max_abs_err=err,
                   int8_op_ms=time_ms(lambda: quant.quant_conv(xd, qk, bd, torch.bfloat16,
                                                               stride, 1)),
                   int_mm_ms=time_ms(lambda: torch._int_mm(cols, wmat.t())),
                   int_mm_bound_ms=int_mm_bound, int_mm_bound_by=int_mm_by,
                   conv2d_bf16_ms=time_ms(lambda: F.conv2d(xd, kd, bd, stride=stride,
                                                           padding=1)),
                   fused_conv_bf16_ms=None, im2col_bytes=cols.numel(),
                   int8_op_peak_extra_bytes=torch.cuda.max_memory_allocated() - base)
        if stride == 1:
            gamma = torch.ones(cin, device=dev)
            beta = torch.zeros(cin, device=dev)
            row["fused_conv_bf16_ms"] = time_ms(lambda: fused_conv.norm_act_conv3x3(
                xd, gamma, beta, kd, bd))
            row["int8_resnet_conv_ms"] = time_ms(lambda: fused_conv.norm_act_conv3x3(
                xd, gamma, beta, qk, bd))
        rows.append(row)
        del cols, shifted, bad_acc
    for name, shape, feats in INT8_DENSE_SHAPES:
        x = torch.randn(shape, generator=gen_cpu).to(torch.bfloat16)
        kern = (torch.randn((feats, shape[-1]), generator=gen_cpu) / math.sqrt(shape[-1])
                ).to(torch.bfloat16)
        got = []
        for d in (dev, cpu):
            qk = quant.quantize_params({"d": {"kernel": kern.to(d)}})["d"]["kernel"]
            qx, sx = quant.quantize_activation(x.to(d))
            acc = quant.dense_int32(qx, qk)
            got.append((qk, qx, acc, quant.dequantize(acc, sx, qk.s, None, torch.bfloat16)))
        (qk, qx, acc, out), (qk_c, qx_c, acc_c, out_c) = got
        for what, a, p in (("weight q", qk.q, qk_c.q), ("weight s", qk.s, qk_c.s),
                           ("activation q", qx, qx_c), ("int32 accumulator", acc, acc_c),
                           ("output", out, out_c)):
            same(f"{name} {what}", a, p)
        a2 = qx.reshape(-1, shape[-1])
        m, kk = a2.shape
        xd, kd = x.to(dev), kern.to(dev)
        int_mm_bound, int_mm_by = bound_ms(2.0 * m * feats * kk,
                                           m * kk + kk * feats + 4 * m * feats, peak=PEAK_INT8_OPS)
        rows.append(dict(shape=name, max_abs_err=(out.float().cpu() - out_c.float())
                         .abs().max().item(),
                         int8_op_ms=time_ms(lambda: quant.quant_dense(xd, qk, None,
                                                                      torch.bfloat16)),
                         int_mm_ms=time_ms(lambda: torch._int_mm(a2, qk.q.t())),
                         int_mm_bound_ms=int_mm_bound, int_mm_bound_by=int_mm_by,
                         linear_bf16_ms=time_ms(lambda: F.linear(xd, kd))))
    for r in rows:
        print(f"int8 op {r['shape']} ({card}): card == plain route bit for bit (max_abs_err "
              f"{r['max_abs_err']:.3e}); int8 op {r['int8_op_ms']:.4f} ms, _int_mm "
              f"{r['int_mm_ms']:.4f} ms (bound {r['int_mm_bound_ms']:.4f} ms by "
              f"{r['int_mm_bound_by']}), "
              + (f"bf16 F.conv2d {r['conv2d_bf16_ms']:.4f} ms, bf16 fused conv "
                 f"{r['fused_conv_bf16_ms']} ms, int8 ResNet conv (GN+SiLU+int8) "
                 f"{r.get('int8_resnet_conv_ms')} ms, im2col {r['im2col_bytes'] / 1e6:.1f} MB, "
                 f"op peak extra {r['int8_op_peak_extra_bytes'] / 1e6:.1f} MB"
                 if "conv2d_bf16_ms" in r else f"bf16 F.linear {r['linear_bf16_ms']:.4f} ms"),
              flush=True)
    if bad:
        fail("int8 op check: " + "; ".join(bad))
    return rows


def int8_phase(dev, pipe, params, gen, card: str):
    """W8A8 int8 serving at full width (module docstring, phase 4d): the op
    check, then "int8" and "int8-static" generations (512 px, 20 UniPC steps)
    on the generation phase's params beside the exact pipeline: B=1 and B=2
    walls, the launches and int8 products of each generation against the
    prediction (no GN statistics or fused conv launch in the steps),
    calibration saved, reloaded into a fresh pipeline and reproducing its
    image bit for bit. Returns (the int8 generations' launches, the saved
    table's path)."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.ops import quant
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    rec = {"card": card, "ops": int8_op_check(dev, card)}
    cfg = pipe.cfg
    pipes = {"exact": pipe, "int8": EdgeStylePipeline(cfg, device=dev, quant="int8"),
             "int8-static": EdgeStylePipeline(cfg, device=dev, quant="int8-static")}
    req1 = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    req2 = make_request(gen, dev, 2, cfg.num_branches, cfg.latent_branches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipes["int8-static"].calibrate_int8(params, *req1[:3])
    torch.cuda.synchronize()
    rec["calibrate_s"] = time.perf_counter() - t0
    table = os.path.join(int8_out_dir(), "int8_scales.json")
    pipes["int8-static"].save_int8_scales(table)
    rec["table_entries"] = len(pipes["int8-static"]._int8_scales)

    def run(mode, req, g):
        return pipes[mode](params, *req[:3], latents=req[3], num_inference_steps=GEN_STEPS,
                           guidance_scale=g)

    bad, images, totals = [], {}, {k: 0 for k in kernels.LAUNCHES}
    torch.cuda.reset_peak_memory_stats()
    for mode in ("exact", "int8", "int8-static"):
        run(mode, req1, 3.5)  # warm-up
        walls = {}
        for b, req, g in ((1, req1, 3.5), (2, req2, [3.5, 7.5])):
            times = []
            for _ in range(INT8_WALL_REPS):
                kernels.reset_launches()
                quant.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run(mode, req, g)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check_images(out, b, f"int8 {mode} B={b}")
                launches, products = dict(kernels.LAUNCHES), dict(quant.COUNTS)
                if mode != "exact":
                    for k, v in launches.items():
                        totals[k] += v
                    want = {k: v * GEN_STEPS for k, v in INT8_PER_STEP.items()}
                    if launches != INT8_LAUNCHES or products != want:
                        bad.append(f"{mode} B={b}: launches {launches} (predicted "
                                   f"{INT8_LAUNCHES}), int8 products {products} (predicted "
                                   f"{want})")
            walls[f"b{b}"] = times
            images[(mode, b)] = out
        rec[mode] = dict(wall_s=walls, launches_per_generation=launches,
                         int8_products_per_generation=products)
        print(f"int8 phase {mode} ({card}): B=1 wall {', '.join(f'{t:.3f}' for t in walls['b1'])}"
              f" s, B=2 wall {', '.join(f'{t:.3f}' for t in walls['b2'])} s; launches per "
              f"generation {launches}, int8 products {products}", flush=True)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for mode in ("int8", "int8-static"):
        d = (images[(mode, 1)] - images[("exact", 1)]).abs()
        rec[mode]["mean_abs_diff_from_exact_b1"] = d.mean().item()
        rec[mode]["max_abs_diff_from_exact_b1"] = d.max().item()
    # the saved table in a fresh pipeline: the same image bit for bit
    fresh = EdgeStylePipeline(cfg, device=dev, quant="int8-static")
    fresh.load_int8_scales(table)
    again = fresh(params, *req1[:3], latents=req1[3], num_inference_steps=GEN_STEPS,
                  guidance_scale=3.5)
    rec["reloaded_table_equal_bitwise"] = bool(torch.equal(again, images[("int8-static", 1)]))
    if not rec["reloaded_table_equal_bitwise"]:
        bad.append("the reloaded table's image differs from the calibrated pipeline's")
    print(f"int8 phase checks ({card}): calibration {rec['calibrate_s']:.3f} s, "
          f"{rec['table_entries']} keys; mean |int8 - exact| (B=1, read, not held) "
          f"{rec['int8']['mean_abs_diff_from_exact_b1']:.4f}, int8-static "
          f"{rec['int8-static']['mean_abs_diff_from_exact_b1']:.4f}; reloaded table bit for "
          f"bit {rec['reloaded_table_equal_bitwise']}; peak {rec['peak_gib']:.2f} GiB",
          flush=True)
    print(json.dumps({"int8": rec}), flush=True)
    if bad:
        fail("int8: " + "; ".join(bad))
    return totals, table


def int8_out_dir() -> str:
    """The int8 phase's calibration table, inside the checkout (git-ignored)."""
    d = os.path.join(HERE, "build", "torch_ext", "chip_smoke_int8")
    os.makedirs(d, exist_ok=True)
    return d


# ----------------------------------------------------------------- export
# Launches of each reloaded per-stage graph at SD1.5 width, 512 px, B=1,
# from the code: one denoise step is GEN_LAUNCHES_PER_REQUEST's step (22
# flash, 104 GN statistics + 104 conv); the VAE encoder has 10 ResNet
# blocks (cond_embed runs it once on the three latent conds in one batch),
# the decoder 14; the text encoder (77 tokens, LayerNorm) and the
# conv-stack cond embedding launch none. The VAE's mid attention (one head
# of 512) is past the flash kernel's head dim.
EXPORT_GRAPH_LAUNCHES = {"text_encoder": (0, 0), "cond_embed": (0, 2 * 10),
                         "unet_controlnet": (22, 104), "vae_encoder": (0, 2 * 10),
                         "vae_decoder": (0, 2 * 14)}
# The aggressive generate program, cut from 20 steps to 2 with the ControlNet
# refreshed at step 0 alone (the preset's schedule, 0 1 2 4 7 11 16, caches
# no step below 3), so that one step reads the cache: its trace, save and
# two reloads take ~5 ms a graph node on the card's host, and 20 steps
# would hold ~140,000 nodes (PERF.md).
EXPORT_GENERATE_STEPS = 2
EXPORT_GENERATE_ARGV = ["--mode", "aggressive", "--steps", str(EXPORT_GENERATE_STEPS),
                        "--controlnet_cache_steps", "0"]
OP_OVERHEAD_CALLS = 2000
# apps/export.py's bf16 bound (the JAX CLI's): the reloaded graph against the
# live function, elementwise, with this share of elements allowed outside
EXPORT_TOL = {"rtol": 5e-2, "atol": 5e-2}
EXPORT_MAX_VIOLATION_FRAC = 0.05


def export_out_dir() -> str:
    """The export phase's artifacts, inside the checkout (git-ignored)."""
    d = os.path.join(HERE, "build", "torch_ext", "chip_smoke_export")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _launch_counts(flash: int, conv: int) -> dict:
    return {"flash_fwd": flash, "gn_scale_shift": conv, "fused_gn_silu_conv3x3": conv,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def _max_diff(a, b) -> float:
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb) or any(x.shape != y.shape for x, y in zip(la, lb)):
        fail("export: a reloaded graph's outputs differ in structure from the live function's")
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(la, lb))


def op_overhead_us(dev) -> dict:
    """Host microseconds a call of the GN statistics launch, at a shape
    small enough that the host bounds it: the ctypes wrapper called
    directly, the ``edgestyle::gn_scale_shift`` operator (ops/library.py's
    ``Library.define`` + ``impl``), and the same wrapper as a
    ``torch.library.custom_op`` made here for the comparison alone. Median
    of three turns each, in the order direct, op, custom, custom, op,
    direct."""
    from edgestyle_tpu_torch.ops import fused_conv

    x = torch.randn((1, 32, 8, 8), device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    gamma, beta = torch.ones(32, device=dev), torch.zeros(32, device=dev)

    @torch.library.custom_op("chip_smoke::gn_scale_shift", mutates_args=())
    def custom(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
               eps: float) -> tuple[torch.Tensor, torch.Tensor]:
        return fused_conv.gn_scale_shift_cuda(x, gamma, beta, groups, eps)

    fns = {"direct": lambda: fused_conv.gn_scale_shift_cuda(x, gamma, beta, 8, 1e-5),
           "op": lambda: fused_conv.GN_SCALE_SHIFT(x, gamma, beta, 8, 1e-5),
           "custom_op": lambda: custom(x, gamma, beta, 8, 1e-5)}
    times = {k: [] for k in fns}
    for k in ("direct", "op", "custom_op") * 2 + ("custom_op", "op", "direct"):
        fn = fns[k]
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_OVERHEAD_CALLS):
            fn()
        torch.cuda.synchronize()
        times[k].append((time.perf_counter() - t0) / OP_OVERHEAD_CALLS * 1e6)
    return {k: statistics.median(v) for k, v in times.items()}


def export_phase(dev, pipe, params, gen, card: str):
    """The deployment export at full width, bf16, B=1 (apps/export.py,
    core/export.py, pipelines/artifact.py): ``--what all`` with each
    reload's parity assert; each reloaded graph on the live pipeline's
    inputs with its launches; a 20-step host-loop generation through the
    graphs against the live ``__call__`` on the same latents (E2E_TOL,
    the generation's launch counts); ``--what generate --mode aggressive``
    (EXPORT_GENERATE_STEPS) served against the live pipeline under the same
    knobs; the try-on CLI with ``--exported_dir``; ``entry()``'s step; the
    operators' host overhead. The generation phase's params drive every
    artifact (the graphs take the weights as inputs)."""
    import numpy as np
    from PIL import Image
    from torch.utils import _pytree as pytree

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import export, tryon
    from edgestyle_tpu_torch.core.export import load_program, parity_violations
    from edgestyle_tpu_torch.entry import entry
    from edgestyle_tpu_torch.pipelines.artifact import ArtifactPipeline, stage_params

    cfg = pipe.cfg
    root = export_out_dir()
    all_dir, gen_dir = os.path.join(root, "all"), os.path.join(root, "aggressive")
    rec = {"card": card}

    # 1. --what all: five programs, each saved, reloaded and held
    t0 = time.perf_counter()
    report = export.main(["--random_init", "--what", "all", "--output_dir", all_dir], device=dev)
    rec["export_all_s"] = time.perf_counter() - t0
    rec["graphs"] = {k: dict(v["export"], flops=v["flops"]) for k, v in report.items()}
    for k, v in rec["graphs"].items():
        print(f"export {k}: trace {v['trace_s']:.2f} s, save {v['save_s']:.2f} s, reload "
              f"{v['load_s']:.2f} s, {v['bytes'] / 2**20:.2f} MiB, {v['nodes']} nodes, "
              f"{v['flops'] / 1e9:.1f} GFLOP, outside the bound {v['violation_frac']:.3e}, "
              f"max abs diff {v['max_abs_diff']:.3e}", flush=True)

    # 2. each reloaded graph on the live pipeline's inputs
    t0 = time.perf_counter()
    art = ArtifactPipeline(all_dir, device=dev)
    enc = load_program(os.path.join(all_dir, "vae_encoder.pt2"))
    rec["artifact_load_s"] = time.perf_counter() - t0
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    imgs = [im.float().contiguous(memory_format=torch.channels_last) for im in imgs]
    sample = lat.float().contiguous(memory_format=torch.channels_last)
    t = torch.tensor(999, dtype=torch.long, device=dev)
    g = torch.tensor(3.5, device=dev)
    sf = cfg.vae.scaling_factor
    noise = torch.randn(lat.shape, generator=gen, device=dev, dtype=pipe.dtype)
    ones = np.ones((cfg.num_branches,), np.float32)
    part = lambda name: stage_params(name, params)  # noqa: E731
    with torch.no_grad():
        ctx = pipe.encode_prompt(params, ids, neg)
        embs = [torch.cat([e, e]) for e in pipe.embed_cond_images(params, imgs)]
        mean, logvar = pipe.vae.encode_moments(params["vae"], imgs[0])
        cases = {
            "text_encoder": (art.graphs["text_encoder"], (part("text_encoder"), ids, neg), ctx),
            "cond_embed": (art.graphs["cond_embed"], (part("cond_embed"), imgs), embs),
            "unet_controlnet": (art.graphs["unet_controlnet"],
                                (part("unet_controlnet"), sample, t, ctx, embs, g),
                                pipe._eval_step(True, params, ctx, None, embs, ones, g, 1, False,
                                                sample, t)),
            "vae_encoder": (enc, (part("vae_encoder"), imgs[0], noise),
                            (mean + torch.exp(0.5 * logvar) * noise) * sf),
            "vae_decoder": (art.graphs["vae_decoder"], (part("vae_decoder"), sample), torch.clamp(
                pipe.vae.decode(params["vae"], sample / sf).float() / 2 + 0.5, 0, 1)),
        }
    rec["reloaded_on_live_inputs"] = {}
    for name, (prog, args, live) in cases.items():
        kernels.reset_launches()
        out = prog.call(*args)
        torch.cuda.synchronize()
        per = dict(kernels.LAUNCHES)
        diff = _max_diff(out, live)
        frac = max(parity_violations(a, b, **EXPORT_TOL)[0] for a, b in zip(
            pytree.tree_leaves(live), pytree.tree_leaves(out)))
        want = _launch_counts(*EXPORT_GRAPH_LAUNCHES[name])
        rec["reloaded_on_live_inputs"][name] = {"max_abs_diff": diff, "violation_frac": frac,
                                                "launches": per}
        print(f"reloaded {name} on the live inputs: max abs diff vs live {diff:.3e}, share "
              f"outside {EXPORT_TOL} {frac:.3e}, launches {per}", flush=True)
        if per != want:
            fail(f"export: reloaded {name} launched {per}, the code predicts {want}")
        if frac > EXPORT_MAX_VIOLATION_FRAC:
            fail(f"export: reloaded {name} differs from the live function beyond the export's "
                 f"bf16 bound")

    # 3. the host loop over the graphs against the live pipeline, 20 steps
    ids, neg, imgs, lat = make_request(gen, dev, 1, cfg.num_branches, cfg.latent_branches)
    art(params, ids, neg, imgs, latents=lat, num_inference_steps=2)  # warm-up
    walls, outs = {"live": [], "artifact": []}, {}
    for which in ("artifact", "live"):
        fn = pipe if which == "live" else art
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[which] = fn(params, ids, neg, imgs, latents=lat, num_inference_steps=GEN_STEPS)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
        if which == "artifact" and dict(kernels.LAUNCHES) != GEN_LAUNCHES_PER_REQUEST:
            fail(f"export: the host-loop generation launched {dict(kernels.LAUNCHES)}, the "
                 f"live generation's counts are {GEN_LAUNCHES_PER_REQUEST}")
    check_images(outs["artifact"], 1, "export host loop")
    diff = (outs["artifact"] - outs["live"]).abs().max().item()
    rec["host_loop"] = {"steps": GEN_STEPS, "max_abs_diff": diff, "artifact_s": walls["artifact"],
                        "live_s": walls["live"]}
    print(f"host loop over the graphs, {GEN_STEPS} UniPC steps: {walls['artifact']} s against "
          f"the live pipeline's {walls['live']} s; image max abs diff {diff:.3e} (tol "
          f"{E2E_TOL})", flush=True)
    if not diff <= E2E_TOL:
        fail("export: the host-loop artifact's image differs from the live pipeline's")
    by_path = {"export": dict(GEN_LAUNCHES_PER_REQUEST)}

    # 4. the aggressive whole-generation program
    argv = ["--random_init", "--what", "generate", *EXPORT_GENERATE_ARGV, "--output_dir",
            gen_dir]
    t0 = time.perf_counter()
    report = export.main(argv, device=dev)
    rec["export_generate_s"] = time.perf_counter() - t0
    rec["generate"] = dict(report["generate"]["export"], flops=report["generate"]["flops"])
    t0 = time.perf_counter()
    gart = ArtifactPipeline(gen_dir, device=dev)
    rec["generate"]["artifact_load_s"] = time.perf_counter() - t0
    knobs = tryon.serving_kwargs(export.parse_args(argv))
    steps = EXPORT_GENERATE_STEPS
    want = serving_launches(steps, knobs["controlnet_cache_steps"], tuple(range(steps)))
    gart(params, ids, neg, imgs, latents=lat, num_inference_steps=steps, **knobs)  # warm-up
    gwalls, gouts = {"live": [], "artifact": []}, {}
    for which in ("artifact", "live"):
        fn = pipe if which == "live" else gart
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gouts[which] = fn(params, ids, neg, imgs, latents=lat, num_inference_steps=steps, **knobs)
        torch.cuda.synchronize()
        gwalls[which].append(time.perf_counter() - t0)
        if which == "artifact" and dict(kernels.LAUNCHES) != want:
            fail(f"export: the generate program launched {dict(kernels.LAUNCHES)}, the code "
                 f"predicts {want}")
    check_images(gouts["artifact"], 1, "export generate")
    diff = (gouts["artifact"] - gouts["live"]).abs().max().item()
    rec["generate"].update(steps=steps, knobs={k: list(v) if isinstance(v, tuple) else v
                                               for k, v in knobs.items()},
                           max_abs_diff=diff, artifact_s=gwalls["artifact"],
                           live_s=gwalls["live"], launches=want)
    print(f"generate program (--mode aggressive, {steps} steps, knobs {knobs}): export "
          f"{rec['export_generate_s']:.2f} s ({rec['generate']['bytes'] / 2**20:.2f} MiB), "
          f"{gwalls['artifact']} s against the live {gwalls['live']} s, image max abs diff "
          f"{diff:.3e} (tol {E2E_TOL})", flush=True)
    if not diff <= E2E_TOL:
        fail("export: the generate program's image differs from the live pipeline's")
    try:
        gart(params, ids, neg, imgs, latents=lat, num_inference_steps=steps)
        fail("export: the generate program served a request without its baked knobs")
    except ValueError:
        pass

    # 5. the try-on CLI on the per-stage artifact
    photos = []
    for i, ph in enumerate(make_photos(3, 3, 512)):
        photos.append(os.path.join(root, f"photo{i}.png"))
        Image.fromarray((ph * 255).astype(np.uint8)).save(photos[-1])
    argv = ["--random_init", "--subject", photos[0], "--clothes1", photos[1], "--clothes2",
            photos[2], "--exported_dir", all_dir, "--out", os.path.join(root, "result.png")]
    kernels.reset_launches()
    t0 = time.perf_counter()
    image = tryon.main(argv, device=dev)
    torch.cuda.synchronize()
    rec["tryon_cli_s"] = time.perf_counter() - t0
    rec["tryon_cli_launches"] = dict(kernels.LAUNCHES)
    print(f"try-on CLI --exported_dir: {rec['tryon_cli_s']:.2f} s, launches "
          f"{rec['tryon_cli_launches']}, image mean {float(image.mean()):.4f}", flush=True)
    if image.shape != (512, 512, 3) or not (np.isfinite(image).all() and image.min() >= 0
                                           and image.max() <= 1):
        fail("export: the try-on CLI's image through the artifact is not a finite [0, 1] "
             "512 px image")
    if rec["tryon_cli_launches"] != GEN_LAUNCHES_PER_REQUEST:
        fail(f"export: the try-on CLI through the artifact launched "
             f"{rec['tryon_cli_launches']}, the generation's counts are "
             f"{GEN_LAUNCHES_PER_REQUEST}")

    # 6. entry(): the flagship step, once
    fn, ex = entry(dev)
    kernels.reset_launches()
    with torch.no_grad():
        noise_pred = fn(*ex)
    torch.cuda.synchronize()
    rec["entry_launches"] = dict(kernels.LAUNCHES)
    if (tuple(noise_pred.shape) != (1, 4, 64, 64) or not torch.isfinite(noise_pred).all()
            or rec["entry_launches"] != _launch_counts(22, 104)):
        fail(f"export: entry()'s step gave {tuple(noise_pred.shape)}, launches "
             f"{rec['entry_launches']}")
    del fn, ex, noise_pred

    # 7. the operators' host cost a call
    rec["op_overhead_us"] = op_overhead_us(dev)
    print(f"host us a call (GN statistics, (1, 32, 8, 8)): {rec['op_overhead_us']}", flush=True)
    print(json.dumps({"export": rec}), flush=True)
    return by_path["export"]


# ----------------------------------------------------------------- serve
SERVE_STEPS = 20
SERVE_WINDOW_MS = 1000.0  # long enough that two of three concurrent requests coalesce
# A coalesced response against the same request served alone, uint8 PNG
# levels: the B=2 generation runs other cuBLAS / cuDNN algorithms and other
# split counts of the fused conv, whose bf16 sums round apart over 20 steps,
# and its photos went through the batched preprocessing (COND_SHARE_TOL).
# Measured on the H100: mean 0.56 and 0.65, max 5 and 6 levels; the limits
# leave three to five times that.
SERVE_MEAN_TOL = 2.0
SERVE_MAX_TOL = 32


def _png_b64(arr01) -> str:
    import base64
    import io

    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.asarray(arr01) * 255).astype(np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _http(url: str, body: bytes = None, timeout: float = 300.0):
    """(status, content type, body, seconds) of a GET (body None) or POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read(), time.perf_counter() - t0


def _start_server(args, system, dev):
    import threading

    from edgestyle_tpu_torch.apps import serve

    srv = serve.build_server(args, system, dev)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def serve_phase(dev, pipe, params, card: str, table: str):
    """apps/serve.py's server in this process (module docstring, phase 4e)
    on the generation phase's pipeline and params, 127.0.0.1, a free port,
    ``--random_init --max_batch 2``, EDGESTYLE_QUANT unset: /healthz, three
    concurrent 512 px requests at 20 steps (two coalesce into one B=2
    generation), each coalesced request served again alone and compared, a
    malformed request's 400 and a request after it; then a server with
    ``--int8_scales`` (int8_phase's table) and EDGESTYLE_QUANT=int8-static,
    one request. Returns the kernels' launches of the phase."""
    import io

    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import serve
    from edgestyle_tpu_torch.apps.tryon import TryOnSystem
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    os.environ.pop("EDGESTYLE_QUANT", None)
    base = ["--host", "127.0.0.1", "--port", "0", "--random_init", "--steps", str(SERVE_STEPS)]
    argv = base + ["--max_batch", "2", "--batch_window_ms", str(SERVE_WINDOW_MS)]
    args = serve.parse_args(argv)
    system = TryOnSystem(random_init=True, args=args, device=dev, pipe=pipe, gen_params=params)
    batches = []
    generate_batch = system.generate_batch

    def recorded(conds, *a, seeds, **kw):
        batches.append(list(seeds))
        return generate_batch(conds, *a, seeds=seeds, **kw)

    system.generate_batch = recorded
    photos = make_photos(3, 9, 512)
    bodies = {seed: json.dumps({"subject": _png_b64(photos[3 * j]),
                                "clothes1": _png_b64(photos[3 * j + 1]),
                                "clothes2": _png_b64(photos[3 * j + 2]),
                                "seed": seed, "guidance": 3.5 + j}).encode()
              for j, seed in enumerate((101, 102, 103))}
    rec, bad = {"card": card, "argv": argv}, []
    kernels.reset_launches()
    srv, url = _start_server(args, system, dev)
    try:
        status, _, body, _ = _http(url + "/healthz")
        if status != 200 or json.loads(body) != {"ok": True}:
            fail(f"serve: /healthz answered {status} {body!r}")
        # warm-up: one request alone (cuBLAS plans, lazy loads), not compared
        _http(url + "/tryon", bodies[101])
        batches.clear()

        def post(seed):
            return seed, _http(url + "/tryon", bodies[seed])

        with ThreadPoolExecutor(3) as pool:
            done = dict(pool.map(post, (101, 102, 103)))
        images = {}
        for seed, (status, ctype, body, secs) in done.items():
            if status != 200 or ctype != "image/png":
                fail(f"serve: request {seed} answered {status} {ctype} {body[:200]!r}")
            images[seed] = np.asarray(Image.open(io.BytesIO(body))).astype(np.int16)
            if images[seed].shape != (512, 512, 3) or images[seed].std() == 0:
                fail(f"serve: request {seed} gave an image of shape {images[seed].shape}, "
                     f"std {images[seed].std()}")
        rec["concurrent_s"] = {str(s): done[s][3] for s in done}
        rec["batches"] = list(batches)
        pairs = [b for b in batches if len(b) == 2]
        if sorted(len(b) for b in batches) != [1, 2] or not pairs:
            fail(f"serve: three concurrent requests ran as generations {batches}, not one of "
                 f"two and one alone")
        status, ctype, body, _ = _http(url + "/tryon", b"{not json")
        rec["malformed_status"] = status
        if status != 400 or "error" not in json.loads(body):
            bad.append(f"a malformed request got {status} {body[:200]!r}")
        status, _, body, secs = _http(url + "/tryon", bodies[103])
        if status != 200:
            bad.append(f"the request after the malformed one got {status}")
        rec["after_malformed_s"] = secs
    finally:
        srv.shutdown()
        srv.server_close()
    # each coalesced request alone: the same system behind a server without
    # batching (--max_batch 1: the handler runs prepare_cond and generate)
    srv1, url1 = _start_server(serve.parse_args(base), system, dev)
    try:
        rec["alone"] = {}
        for seed in pairs[0]:
            status, ctype, body, secs = _http(url1 + "/tryon", bodies[seed])
            if status != 200 or ctype != "image/png":
                fail(f"serve: request {seed} alone answered {status} {ctype} {body[:200]!r}")
            alone = np.asarray(Image.open(io.BytesIO(body))).astype(np.int16)
            d = np.abs(alone - images[seed])
            rec["alone"][str(seed)] = dict(s=secs, mean_abs_diff=float(d.mean()),
                                           max_abs_diff=int(d.max()))
            if not (d.mean() <= SERVE_MEAN_TOL and d.max() <= SERVE_MAX_TOL):
                bad.append(f"request {seed} coalesced vs alone: mean {d.mean():.3f} max "
                           f"{d.max()} levels (tol {SERVE_MEAN_TOL}, {SERVE_MAX_TOL})")
    finally:
        srv1.shutdown()
        srv1.server_close()
    totals = dict(kernels.LAUNCHES)

    # int8-static from the table int8_phase saved, through --int8_scales
    os.environ["EDGESTYLE_QUANT"] = "int8-static"
    try:
        args8 = serve.parse_args(base + ["--int8_scales", table])
        pipe8 = EdgeStylePipeline(pipe.cfg, device=dev)
        system8 = TryOnSystem(random_init=True, args=args8, device=dev, pipe=pipe8,
                              gen_params=params)
        if pipe8.quant != "int8-static" or pipe8._int8_scales is None:
            fail("serve: EDGESTYLE_QUANT=int8-static with --int8_scales did not load the table")
        kernels.reset_launches()
        srv8, url8 = _start_server(args8, system8, dev)
        try:
            status, ctype, body, secs = _http(url8 + "/tryon", bodies[101])
        finally:
            srv8.shutdown()
            srv8.server_close()
        if status != 200 or ctype != "image/png":
            fail(f"serve: the int8-static request answered {status} {body[:200]!r}")
        img8 = np.asarray(Image.open(io.BytesIO(body)))
        rec["int8_static"] = dict(s=secs, launches=dict(kernels.LAUNCHES),
                                  image_std=float(img8.std()))
        if img8.shape != (512, 512, 3) or img8.std() == 0:
            bad.append(f"the int8-static image has shape {img8.shape}, std {img8.std()}")
        if kernels.LAUNCHES["fused_gn_silu_conv3x3"] != VAE_CONV_LAUNCHES:
            bad.append(f"the int8-static request launched the fused conv "
                       f"{kernels.LAUNCHES['fused_gn_silu_conv3x3']} times, not the VAE's "
                       f"{VAE_CONV_LAUNCHES}")
        for k, v in kernels.LAUNCHES.items():
            totals[k] += v
    finally:
        os.environ.pop("EDGESTYLE_QUANT", None)
    print(f"serve ({card}): three concurrent requests in {rec['concurrent_s']} s, as "
          f"generations {rec['batches']}; coalesced vs alone {rec['alone']} (tol mean "
          f"{SERVE_MEAN_TOL}, max {SERVE_MAX_TOL} levels); malformed -> "
          f"{rec['malformed_status']}; int8-static request {rec['int8_static']['s']:.3f} s",
          flush=True)
    print(json.dumps({"serve": rec}), flush=True)
    if bad:
        fail("serve: " + "; ".join(bad))
    return totals


# ----------------------------------------------------- photos -> try-on
def make_photos(seed: int, n: int, size: int):
    """n (size, size, 3) photos in [0, 1], numpy: a smooth colour field (a
    few random low-frequency waves per channel) and a bright, upright
    subject blob, as tests/fused_golden.py makes its 32 px photos."""
    import numpy as np

    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    photos = []
    for _ in range(n):
        field = np.zeros((size, size, 3))
        for c in range(3):
            for _ in range(3):
                fy, fx = g.uniform(0.5, 3.0, 2)
                field[..., c] += np.cos(2 * np.pi * (fy * y + fx * x) + g.uniform(0, 2 * np.pi))
        field = 0.5 + field / 6.0
        cy, cx = 0.5 + g.uniform(-0.05, 0.05, 2)
        blob = np.exp(-((y - cy) ** 2 / (2 * 0.22 ** 2) + (x - cx) ** 2 / (2 * 0.1 ** 2)))
        photos.append(np.clip(0.5 * field + 0.5 * blob[..., None], 0, 1).astype(np.float32))
    return photos


def _cond_diff_share(a, b) -> float:
    """Share of pixels of two (H, W, 3) images that differ by more than 1e-5
    in any channel."""
    import numpy as np

    return float(np.any(np.abs(a - b) > 1e-5, axis=-1).mean())


def _wall(fn, reps: int):
    """Median host seconds of `reps` calls of fn, each ending on the host
    (fn returns host arrays), and the last result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def tryon_system_phase(dev, pipe, params, card: str):
    """TryOnSystem at full width from seed 0 on the generation phase's
    pipeline and params: timings, launch counts and checks (module
    docstring, phase 4b). Returns the kernels' launches of the photos ->
    image call."""
    import numpy as np

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps.tryon import TryOnSystem
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids
    from edgestyle_tpu_torch.models.efficientvit.sam import (
        EfficientViTSam,
        boxes_to_points,
        preprocess_sam_image,
    )
    from edgestyle_tpu_torch.models.openpose import preprocess_for_openpose, render_pose
    from edgestyle_tpu_torch.ops.morphology import component_labels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system = TryOnSystem(seed=0, device=dev, pipe=pipe, gen_params=params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    size = system.preproc.cfg.image_size
    photos = make_photos(0, 6, size)
    triples = [photos[0:3], photos[3:6]]
    rec = {"card": card, "init_s": init_s}

    # module times: device ms of back-to-back calls queued behind a sleep
    with torch.no_grad():
        x1 = preprocess_for_openpose(torch.from_numpy(photos[0][None]).permute(0, 3, 1, 2)
                                     .to(dev), system.pose_size)
        x3 = torch.cat([x1, x1, x1])
        rec["pose_net_ms_b1"] = time_ms(lambda: system.pose_net(system.pose_params, x1), 5)
        rec["pose_net_ms_b3"] = time_ms(lambda: system.pose_net(system.pose_params, x3), 5)
        sam, sp = system.preproc.sam, system.sam_params["sam"]
        img = preprocess_sam_image(torch.from_numpy(photos[0][None]).permute(0, 3, 1, 2).to(dev))
        box = torch.tensor([[100.0, 150.0, 400.0, 480.0]], device=dev) * system.preproc.prompt_scale
        pts, lbl = boxes_to_points(box)
        rec["sam_encoder_ms"] = time_ms(lambda: sam.encode_image(sp, img), 5)
        rec["sam_encoder_decode_ms"] = time_ms(
            lambda: sam.decode(sp, sam.encode_image(sp, img), pts, lbl, True), 5)

    # preprocessing per triple at B=1 and B=2 (host clock, results on the host)
    system.prepare_cond_batch([photos[0]], [photos[1]], [photos[2]])  # warm-up
    for b in (1, 2):
        sel = triples[:b]
        wall, conds = _wall(lambda: system.prepare_cond_batch(
            [t[0] for t in sel], [t[1] for t in sel], [t[2] for t in sel]), 3)
        rec[f"preprocess_s_b{b}"] = wall
        rec[f"preprocess_s_per_triple_b{b}"] = wall / b
    for c in conds:
        for k, v in c.items():
            want = (512, 512, 3) if k.endswith("pose") else (size, size, 3)
            if v.shape != want:
                fail(f"tryon_system: cond {k} has shape {v.shape}, want {want}")
            if not (np.isfinite(v).all() and v.min() >= 0 and v.max() <= 1):
                fail(f"tryon_system: cond {k} is not finite in [0, 1]")
    seq = [system.prepare_cond(*t) for t in triples]
    shares = {f"{i}/{k}": _cond_diff_share(conds[i][k], seq[i][k])
              for i in range(2) for k in seq[i]}
    rec["batched_vs_sequential_max_share"] = max(shares.values())

    # device launches and device time of one preprocessing (B=1), profiled
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.prepare_cond_batch([photos[0]], [photos[1]], [photos[2]])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    rec["preprocess_b1_device_launches"] = sum(r[1] for r in rows)
    rec["preprocess_b1_device_ms"] = sum(r[0] for r in rows)
    rec["preprocess_b1_profiled_wall_s"] = prof_wall
    rec["params"] = {"pose_net": _numel(system.pose_params),
                     "sam_base": _numel(system.sam_params["sam"]),
                     "sam_heads": _numel(system.sam_params["decoders"])}

    # the mask algebra's connected components: sweeps (= host syncs)
    with torch.no_grad():
        kps = torch.full((6, 18, 2), float("nan"), device=dev)
        out = system.preproc(system.sam_params,
                             torch.from_numpy(np.stack(photos)).permute(0, 3, 1, 2).to(dev), kps)
        rec["person_mask_share"] = out.person_mask.float().mean().item()
        rec["largest_component_sweeps_6_person_masks"] = component_labels(out.person_mask)[1]
        serp = torch.from_numpy(serpentine_and_blobs(size)[0][:1]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec["largest_component_sweeps_serpentine"] = component_labels(serp)[1]
        torch.cuda.synchronize()
        rec["largest_component_serpentine_s"] = time.perf_counter() - t0

    # fp32 SAM-L2 on the card (TF32 off, as main sets it; then once with
    # TF32 on, read but not held) against the CPU, same params and image
    with torch.no_grad():
        sam32 = EfficientViTSam(system.preproc.cfg, torch.float32)

        def sam32_run(d):
            p = sp if d == dev else _to(sp, d)
            emb = sam32.encode_image(p, img.to(d))
            masks, _ = sam32.decode(p, emb, pts.to(d), lbl.to(d), True)
            return emb.float().cpu(), masks.float().cpu()

        ref = sam32_run(torch.device("cpu"))
        rel = lambda out: [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(out, ref)]
        errs = rel(sam32_run(dev))
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            errs_tf32 = rel(sam32_run(dev))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rec["sam_fp32_card_vs_cpu_rel_err"] = {"embedding": errs[0], "mask_logits": errs[1]}
    rec["sam_fp32_card_tf32_on_vs_cpu_rel_err"] = {"embedding": errs_tf32[0],
                                                   "mask_logits": errs_tf32[1]}

    # a skeleton render on the card against the CPU's
    kp01 = torch.tensor(make_skeleton(), dtype=torch.float32)
    r_card = render_pose(kp01.to(dev), (512, 512)).cpu()
    r_cpu = render_pose(kp01, (512, 512))
    rec["render_card_vs_cpu_share"] = (r_card != r_cpu).any(dim=1).float().mean().item()

    # the mask algebra and the pose decode on structured inputs, card against CPU
    t0 = time.perf_counter()
    structure, structure_bad = structure_checks(dev, size, photos)
    structure["s"] = time.perf_counter() - t0
    rec["structure"] = structure

    # one full photos -> image call, 20 steps, the generation's launches counted
    ids = empty_prompt_ids()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = system(*triples[0], ids, ids, steps=GEN_STEPS)
    torch.cuda.synchronize()
    rec["photos_to_image_s"] = time.perf_counter() - t0
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels.reset_launches()

    print(f"tryon_system ({card}): init {init_s:.2f} s; BodyPoseNet {system.pose_size} px fp32 "
          f"{rec['pose_net_ms_b1']:.4f} ms (B=1), {rec['pose_net_ms_b3']:.4f} ms (B=3); "
          f"EfficientViT-L2-SAM {size} px bf16 encoder {rec['sam_encoder_ms']:.4f} ms, encoder + "
          f"one box decode {rec['sam_encoder_decode_ms']:.4f} ms; preprocessing (pose, 5 SAM "
          f"decodes, masks, renders, to the host) {rec['preprocess_s_per_triple_b1']:.4f} s per "
          f"triple at B=1, {rec['preprocess_s_per_triple_b2']:.4f} s per triple at B=2; one B=1 "
          f"preprocessing {rec['preprocess_b1_device_launches']} device launches, "
          f"{rec['preprocess_b1_device_ms']:.3f} ms device time in "
          f"{rec['preprocess_b1_profiled_wall_s']:.3f} s (profiler on); photos -> image "
          f"({GEN_STEPS} steps) {rec['photos_to_image_s']:.3f} s; peak device memory "
          f"{rec['peak_memory_gib']:.2f} GiB", flush=True)
    print(f"  params: {rec['params']}; one B=1 preprocessing under the profiler by kernel "
          f"family:", flush=True)
    _print_families(rows, rec["preprocess_b1_device_ms"] / 1e3)
    print(f"  largest_component: {rec['largest_component_sweeps_6_person_masks']} sweeps (one "
          f"host sync each) for the 6 person masks (person share "
          f"{rec['person_mask_share']:.3f}); a {size} px serpentine "
          f"{rec['largest_component_sweeps_serpentine']} sweeps in "
          f"{rec['largest_component_serpentine_s']:.3f} s", flush=True)
    print(f"  checks: batched vs sequential prepare_cond, worst share of differing pixels "
          f"{rec['batched_vs_sequential_max_share']:.2e} (tol {COND_SHARE_TOL}); fp32 SAM-L2 "
          f"card vs CPU (TF32 off) embedding {errs[0]:.2e}, mask logits {errs[1]:.2e} of their "
          f"max (tol {SAM_FP32_REL_TOL}; with TF32 on {errs_tf32[0]:.2e} / {errs_tf32[1]:.2e}, "
          f"not held); skeleton render card vs CPU "
          f"{rec['render_card_vs_cpu_share']:.2e} of pixels (tol {RENDER_SHARE_TOL}); image "
          f"{image.shape} mean {float(image.mean()):.4f} std {float(image.std()):.4f}; generation "
          f"launches {rec['launches']}", flush=True)
    print(f"  structured inputs, card vs CPU in {structure['s']:.2f} s: mask algebra on three "
          f"{size} px sets of head masks (person shares {structure['structured_person_share']}), "
          f"largest_component on a serpentine and three discs (known answers "
          f"{structure['largest_component_known_answers']}), pose decode on synthetic maps "
          f"(parts found {structure['pose_decode_parts_found']}, renders differ on "
          f"{structure['pose_decode_render_card_vs_cpu_share']:.2e}); "
          f"{'; '.join(structure_bad) or 'all equal'}", flush=True)
    print(json.dumps({"tryon_system": rec}), flush=True)

    if structure_bad:
        fail("tryon_system: " + "; ".join(structure_bad))

    if rec["batched_vs_sequential_max_share"] > COND_SHARE_TOL:
        worst = sorted(shares.items(), key=lambda kv: -kv[1])[:4]
        fail(f"tryon_system: prepare_cond_batch differs from prepare_cond: {worst}")
    if not max(errs) <= SAM_FP32_REL_TOL:
        fail("tryon_system: the fp32 SAM-L2 on the card disagrees with the CPU")
    if not rec["render_card_vs_cpu_share"] <= RENDER_SHARE_TOL:
        fail("tryon_system: the skeleton render on the card disagrees with the CPU's")
    if image.shape != (512, 512, 3) or not (np.isfinite(image).all() and image.min() >= 0
                                           and image.max() <= 1 and image.std() > 0):
        fail("tryon_system: the photos -> image output is not a finite [0, 1] image")
    if rec["launches"] != GEN_LAUNCHES_PER_REQUEST:
        fail(f"tryon_system: the generation's kernel launches differ from the counts the "
             f"code predicts {GEN_LAUNCHES_PER_REQUEST}")
    del system
    return rec["launches"]


def person_keypoints():
    """One person's (18, 2) keypoints in the pixels of a 46 x 46 heatmap
    (tests/test_openpose.py's synthetic person)."""
    import numpy as np

    return np.array([[23, 6], [23, 12], [18, 12], [15, 19], [13, 25], [28, 12], [31, 19],
                     [33, 25], [20, 26], [20, 34], [20, 42], [26, 26], [26, 34], [26, 42],
                     [21, 4], [25, 4], [19, 5], [27, 5]], np.float32)


def make_skeleton():
    """Two people's (18, 2) keypoints in [0, 1] (the second missing its
    right arm), as tests/test_openpose.py's synthetic person."""
    import numpy as np

    kps = person_keypoints() / 46.0
    two = np.stack([kps, kps * 0.8 + 0.1])
    two[1, 2:5] = np.nan
    return two


def synthetic_pose_maps(people, h: int, w: int):
    """(1, 38, h, w) PAF and (1, 19, h, w) heatmaps, numpy, of people given
    as (18, 2) heatmap-pixel keypoints (NaN = missing), painted as
    tests/test_openpose.py paints its person: a gaussian at each part, each
    limb's unit vector in a 3 px corridor along it."""
    import numpy as np

    from edgestyle_tpu_torch.models.openpose import LIMB_SEQ, MAP_IDX

    heat = np.zeros((19, h, w), np.float32)
    paf = np.zeros((38, h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for kps in people:
        for part, (x, y) in enumerate(kps):
            if not np.isnan(x):
                heat[part] = np.maximum(heat[part],
                                        np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / 4.0))
        for limb, (a, b) in enumerate(LIMB_SEQ):
            (xa, ya), (xb, yb) = kps[a], kps[b]
            if np.isnan(xa) or np.isnan(xb):
                continue
            n = np.hypot(xb - xa, yb - ya) + 1e-6
            u = ((xb - xa) / n, (yb - ya) / n)
            t = ((xs - xa) * u[0] + (ys - ya) * u[1]) / n
            d = np.hypot(xs - (xa + t * n * u[0]), ys - (ya + t * n * u[1]))
            m = (t >= 0) & (t <= 1) & (d < 3)
            paf[MAP_IDX[limb][0]][m] = u[0]
            paf[MAP_IDX[limb][1]][m] = u[1]
    return paf[None], heat[None]


def pose_decode_inputs():
    """Pose maps of three 92 x 92 heatmaps with known answers, and the
    keypoints the decode must pick (None: no person passes the filters):
    a small person at the top left and a large one at the right (the larger
    is picked), one person without hips (filtered out), nobody."""
    import numpy as np

    kps = person_keypoints()
    large = kps + np.float32([46, 20])
    small = kps * 0.8 + np.float32([2, 4])
    no_hips = kps.copy()
    no_hips[[8, 11]] = np.nan
    maps = [synthetic_pose_maps(people, 92, 92) for people in ([small, large], [no_hips], [])]
    paf, heat = (np.concatenate([m[i] for m in maps]) for i in range(2))
    return paf, heat, [large, None, None]


def structured_masks(seed: int, n: int, size: int):
    """n sets of the four SAM heads' raw (size, size) bool masks, numpy,
    with a known answer: 'subject' an elliptic body and a round head that
    touches it, plus a stray disc apart from them; 'head' the head;
    'clothes' the torso's box; 'agnostic' the body less a box that
    overlaps the clothes' (so the two overlap); and salt-and-pepper specks
    (0.2% each) in every mask. Returns (masks: name -> (n, size, size),
    stray: (n, size, size) the stray disc, centres: (n, 2, 2) the (y, x)
    of the body's and the head's centres)."""
    import numpy as np

    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    out = {k: [] for k in ("subject", "agnostic", "clothes", "head")}
    strays, centres = [], []
    for _ in range(n):
        cx, cy = g.uniform(0.4, 0.6), g.uniform(0.58, 0.62)
        ax, ay = g.uniform(0.12, 0.16), g.uniform(0.26, 0.3)
        body = ((x - cx) / ax) ** 2 + ((y - cy) / ay) ** 2 <= 1
        hy, hr = cy - ay - 0.06, g.uniform(0.07, 0.09)
        head = (x - cx) ** 2 + (y - hy) ** 2 <= hr ** 2
        top = cy - 0.2
        clothes = (abs(x - cx) <= ax - 0.02) & (y >= top) & (y <= top + 0.24)
        hole = (abs(x - cx) <= ax - 0.02) & (y >= top + 0.04) & (y <= top + 0.28)
        stray = (x - 0.1) ** 2 + (y - 0.1) ** 2 <= g.uniform(0.03, 0.05) ** 2
        for k, m in (("subject", body | head | stray), ("agnostic", body & ~hole),
                     ("clothes", clothes), ("head", head)):
            salt, pepper = g.random((size, size)) < 2e-3, g.random((size, size)) < 2e-3
            out[k].append((m | salt) & ~pepper)
        strays.append(stray)
        centres.append([[cy, cx], [hy, cx]])
    centres = (np.array(centres) * size).astype(np.int64)
    return {k: np.stack(v) for k, v in out.items()}, np.stack(strays), centres


def serpentine_and_blobs(size: int):
    """Two (size, size) bool masks, numpy, and the largest 4-connected
    component of each: a serpentine of size / 2 tracks (one component, all
    of it) and three discs of radii 0.06, 0.1 and 0.08 of the side (the
    middle one)."""
    import numpy as np

    serp = np.zeros((size, size), bool)
    serp[::2, :] = True
    serp[1::4, -1] = True
    serp[3::4, 0] = True
    y, x = np.mgrid[0:size, 0:size] / size
    discs = [(x - cx) ** 2 + (y - cy) ** 2 <= r ** 2
             for cx, cy, r in ((0.2, 0.2, 0.06), (0.6, 0.5, 0.1), (0.25, 0.75, 0.08))]
    return np.stack([serp, discs[0] | discs[1] | discs[2]]), np.stack([serp, discs[1]])


def structure_checks(dev, size: int, photos) -> dict:
    """The mask algebra and the pose decode on inputs with structure, card
    (``dev``) against the same code on the CPU; with random weights the
    system's own masks cover the whole photo and no person is found, so
    these inputs are made here. Returns the readings and the failures."""
    import numpy as np

    from edgestyle_tpu_torch.apps.tryon import CANVAS, decode_pose_batch
    from edgestyle_tpu_torch.ops.morphology import composite_gray, largest_component, mask_bbox
    from edgestyle_tpu_torch.pipelines.preprocess import HEAD_NAMES, combine_masks

    cpu = torch.device("cpu")
    bad, rec = [], {}

    # the mask algebra on three structured sets of head masks
    raw, stray, centres = structured_masks(1, 3, size)
    imgs = torch.from_numpy(np.stack(photos[:3])).permute(0, 3, 1, 2)
    res = {}
    for d in (dev, cpu):
        m = {k: torch.from_numpy(v).to(d) for k, v in raw.items()}
        masks = combine_masks(*(m[k] for k in HEAD_NAMES))
        res[d] = [t.cpu() for t in masks] + [
            mask_bbox(masks[0], 20).cpu(), mask_bbox(m["subject"], 20).cpu(),
            composite_gray(imgs.to(d), masks[0]).cpu()]
        if d == dev:
            per_image = [combine_masks(*(m[k][i:i + 1] for k in HEAD_NAMES)) for i in range(3)]
            if not all(torch.equal(torch.cat([p[j] for p in per_image]), masks[j])
                       for j in range(4)):
                bad.append("combine_masks on the card: the batch differs from per-image calls")
    names = ("person", "agnostic", "clothes", "head", "person_bbox", "subject_bbox", "composite")
    for name, a, b in zip(names, res[dev], res[cpu]):
        # the gray background is 127 / 255, which CUDA divides as a product
        # with the reciprocal: one fp32 ulp off the CPU's; the rest is exact
        same = (torch.allclose(a, b, rtol=0, atol=1e-6) if name == "composite"
                else torch.equal(a, b))
        if not same:
            bad.append(f"mask algebra: {name} on the card differs from the CPU's "
                       f"({(a != b).float().mean().item():.2e} of its elements)")
    person, agnostic, clothes, head = res[cpu][:4]
    rec["structured_person_share"] = [round(v, 4) for v in person.float().mean((1, 2)).tolist()]
    idx = torch.arange(3)
    if not (0 < min(rec["structured_person_share"]) and max(rec["structured_person_share"]) < 1
            and not (person & torch.from_numpy(stray)).any()
            and person[idx, centres[:, 0, 0], centres[:, 0, 1]].all()
            and person[idx, centres[:, 1, 0], centres[:, 1, 1]].all()
            and not (agnostic & clothes).any() and agnostic.any() and clothes.any()
            and not (head & ~person).any()):
        bad.append("mask algebra: the person mask lost the body or the head, kept the stray "
                   "disc, or the agnostic and clothes masks overlap")

    # largest_component alone: a serpentine (all of it) and three discs (the largest)
    masks, want = (torch.from_numpy(a) for a in serpentine_and_blobs(size))
    got = {d: largest_component(masks.to(d)).cpu() for d in (dev, cpu)}
    rec["largest_component_known_answers"] = bool(torch.equal(got[dev], want))
    if not torch.equal(got[dev], got[cpu]):
        bad.append("largest_component on the card differs from the CPU's")
    if not torch.equal(got[dev], want):
        bad.append("largest_component did not keep the whole serpentine or the largest disc")

    # the pose decode on synthetic maps with known people
    paf, heat, want_kps = pose_decode_inputs()
    dec = {d: decode_pose_batch(torch.from_numpy(paf).to(d), torch.from_numpy(heat).to(d))
           for d in (dev, cpu)}
    (kc, sc), (kh, sh) = dec[dev], dec[cpu]
    for i, w in enumerate(want_kps):
        if (kc[i] is None) != (kh[i] is None) or (
                kc[i] is not None and not np.allclose(kc[i], kh[i], atol=1e-4, equal_nan=True)):
            bad.append(f"pose decode: image {i}'s person on the card differs from the CPU's")
        if (kc[i] is None) != (w is None):
            bad.append(f"pose decode: image {i}: a person was {'not ' if w is not None else ''}"
                       "expected")
        elif w is not None and not np.allclose(kc[i], w * CANVAS / heat.shape[2], atol=1e-3):
            # the planted parts sit on whole heatmap pixels: every one is found there
            bad.append(f"pose decode: image {i}'s keypoints are off the planted person")
    rec["pose_decode_parts_found"] = [0 if k is None else int(np.isfinite(k[:, 0]).sum())
                                      for k in kc]
    rec["pose_decode_render_card_vs_cpu_share"] = float(
        np.any(sc != sh, axis=-1).mean())
    if rec["pose_decode_render_card_vs_cpu_share"] > RENDER_SHARE_TOL:
        bad.append("pose decode: the renders on the card differ from the CPU's")
    return rec, bad


def _numel(tree) -> int:
    return sum(_numel(v) if isinstance(v, dict) else v.numel() for v in tree.values())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


# ---------------------------------------------------------------- training
TRAIN_STEPS = 3
TRAIN_ARGV = ["--random_init", "--resolution", "512", "--train_batch_size", "2",
              "--gradient_accumulation_steps", "1", "--max_train_steps", str(TRAIN_STEPS),
              "--mixed_precision", "bf16", "--logging_steps", "1", "--seed", "0"]
# Launches per micro-step, from the code at SD1.5 width and 512 px:
#   flash_fwd: every self-attention with >= 1024 tokens: the UNet's 10 (down
#     blocks 0-1, up blocks 2-3) and 4 in each of the 3 ControlNet trunks;
#   fused conv, and the GN statistics before each: 2 per ResNet block: the
#     VAE encoder's 10 (run twice: the image, then the three VAE conds), the
#     UNet's 22, each trunk's 10;
#   flash_bwd_*: only attentions whose output needs a gradient: the UNet's
#     up-block self-attentions (6; its down path sees no trainable) and the
#     two LoRA trunks' 4 each (the static trunk is frozen and has no
#     trainable upstream).
TRAIN_LAUNCHES_PER_STEP = {"flash_fwd": 10 + 3 * 4,
                           "gn_scale_shift": 2 * (2 * 10 + 22 + 3 * 10),
                           "fused_gn_silu_conv3x3": 2 * (2 * 10 + 22 + 3 * 10),
                           "flash_bwd_dq": 6 + 2 * 4, "flash_bwd_dkv": 6 + 2 * 4}


def train_out_dir() -> str:
    """Checkpoints of the training phase, inside the checkout (git-ignored)."""
    return os.path.join(HERE, "build", "torch_ext", "chip_smoke_train")


def training_phase(dev):
    """The trainer's entry point at full width for TRAIN_STEPS steps, with
    the launch counts and the peak memory read around it alone. Returns
    (launches, (pipe, frozen, tcfg, initial state), steady seconds per
    step): the initial state is rebuilt afterwards from the same seed by the
    same ``build`` that ``main`` calls, to show what moved."""
    import shutil

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.training import checkpoint
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    out_dir = train_out_dir()
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--output_dir", out_dir]
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    log = res["log"]
    if [r["step"] for r in log] != list(range(1, TRAIN_STEPS + 1)):
        fail(f"training logged steps {[r['step'] for r in log]}")
    losses, ds = [r["loss"] for r in log], [r["d"] for r in log]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss {losses}")
    if not all(b >= a for a, b in zip(ds, ds[1:])):
        fail(f"Prodigy's d fell: {ds}")
    ends = [0.0] + [r["elapsed_s"] for r in log]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    steady = sum(step_s[1:]) / len(step_s[1:])
    b = 2
    print(f"training ({TRAIN_STEPS} steps, micro-batch {b}, 512 px, Prodigy, snr_gamma 5): "
          f"losses {losses}, d {ds}; seconds per step {[round(x, 4) for x in step_s]} "
          f"(first includes warm-up); steady {steady:.4f} s/step, {steady / b:.4f} s/sample; "
          f"main() wall {wall:.2f} s (build and checkpoint included); peak device memory of "
          f"main() alone {peak:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    built = train.build(train.parse_args(argv), dev)
    torch.cuda.synchronize()
    print(f"trainer build again for the checks (full-width SD1.5, frozen bf16, trainables "
          f"fp32): {time.perf_counter() - t0:.2f} s", flush=True)
    pipe, frozen0, tcfg, state0, _ = built
    init = flatten(state0["trainable"])
    final = flatten(res["state"]["trainable"])
    for group in TRAINABLE_GROUPS:
        keys = [k for k in init if k[0] == group]
        moved = [k for k in keys if not torch.equal(final[k], init[k])]
        delta = max((final[k] - init[k]).abs().max().item() for k in keys)
        print(f"  {group}: {len(moved)} of {len(keys)} leaves moved, max |change| "
              f"{delta:.3e}", flush=True)
        if not moved:
            fail(f"trainable group {group} did not move")
    frozen = flatten(res["frozen"])
    if frozen.keys() != flatten(frozen0).keys() or not all(
            torch.equal(frozen[k], v) for k, v in flatten(frozen0).items()):
        fail("a frozen weight changed in training")
    back = checkpoint.load_checkpoint(out_dir, device=dev)
    if back["step"] != TRAIN_STEPS or not checkpoint.states_equal(back, res["state"]):
        fail("the final checkpoint does not read back equal to the trained state")
    print(f"  frozen weights unchanged ({len(frozen)} leaves); checkpoint-{back['step']} read "
          f"back equal", flush=True)

    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    print(f"training launches per step {per_step}, predicted {TRAIN_LAUNCHES_PER_STEP}",
          flush=True)
    if per_step != TRAIN_LAUNCHES_PER_STEP:
        fail("the training step's kernel launches differ from the counts the code predicts")
    del res, back, frozen, final
    return launches, (pipe, frozen0, tcfg, state0), steady


def fp32_training_phase(dev) -> None:
    """One step of the trainer's entry point with ``--mixed_precision no``
    at micro-batch 1: an fp32 model on the card runs its long attentions
    through the flash kernels (q, k, v and dO rounded to bf16 on the way
    in), so the step launches the flash kernels as a bf16 step does, and
    takes the conv's plain version (the conv kernel multiplies bf16 weights
    only, as the reference sends non-bf16 convs to XLA), so it launches no
    GN statistics or conv kernel. Its loss must be finite and its weights
    fp32."""
    import shutil

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten

    out_dir = train_out_dir() + "_fp32"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--mixed_precision", "no", "--train_batch_size", "1",
                         "--max_train_steps", "1", "--output_dir", out_dir]
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [r["loss"] for r in res["log"]]
    dtypes = {v.dtype for tree in (res["frozen"], res["state"]["trainable"])
              for v in flatten(tree).values() if v.is_floating_point()}
    print(f"fp32 training (--mixed_precision no, 1 step, micro-batch 1, 512 px): losses "
          f"{losses}; weight dtypes {sorted(map(str, dtypes))}; kernel launches {launches}; "
          f"main() wall {wall:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    if len(losses) != 1 or not all(math.isfinite(x) for x in losses):
        fail(f"the fp32 training step's loss is not one finite value: {losses}")
    if dtypes != {torch.float32}:
        fail(f"the fp32 model holds weights of other types: {dtypes}")
    predicted = {k: v if k.startswith("flash") else 0
                 for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    print(f"  fp32 launches predicted {predicted}", flush=True)
    if launches != predicted:
        fail("the fp32 training step's kernel launches differ from the counts the code "
             "predicts")
    del res


# -------------------------------------------------------------- pretrained
# Parameter counts of the full-width diffusers SD1.5 UNet and VAE (the
# diffusers modules' own) and of HF's CLIP-L text tower (without its
# position_ids buffer).
PRETRAINED_ANCHORS = {"unet": 859_520_964, "vae": 83_653_863, "text_encoder": 123_060_480}
PRETRAINED_RANK = 32  # the trained set's adapters (linear and conv)
# file -> (subdirectory, file name, dtype written): the public SD1.5 files
# are fp16, the VAE fp32
PRETRAINED_FILES = {
    "unet": ("pretrained/unet", "diffusion_pytorch_model.safetensors", torch.float16),
    "text_encoder": ("pretrained/text_encoder", "model.safetensors", torch.float16),
    "vae": ("vae", "diffusion_pytorch_model.safetensors", torch.float32),
    "openpose": ("openpose", "diffusion_pytorch_model.safetensors", torch.float16),
}


def clip_text_manifest(layers=12, width=768, positions=77, vocab=49408, mlp=3072):
    """Key -> shape of HF's CLIPTextModel at clip-vit-large-patch14's text
    width, from HF's key grammar, with the I64 position_ids buffer."""
    m = {"text_model.embeddings.token_embedding.weight": (vocab, width),
         "text_model.embeddings.position_embedding.weight": (positions, width),
         "text_model.embeddings.position_ids": (1, positions),
         "text_model.final_layer_norm.weight": (width,),
         "text_model.final_layer_norm.bias": (width,)}
    for i in range(layers):
        p = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{p}.self_attn.{proj}.weight"], m[f"{p}.self_attn.{proj}.bias"] = \
                (width, width), (width,)
        for ln in ("layer_norm1", "layer_norm2"):
            m[f"{p}.{ln}.weight"], m[f"{p}.{ln}.bias"] = (width,), (width,)
        m[f"{p}.mlp.fc1.weight"], m[f"{p}.mlp.fc1.bias"] = (mlp, width), (mlp,)
        m[f"{p}.mlp.fc2.weight"], m[f"{p}.mlp.fc2.bias"] = (width, mlp), (width,)
    return m


def sd15_manifests():
    """Key -> shape of the full-width diffusers UNet2DConditionModel, openpose
    ControlNetModel and AutoencoderKL: tests/torch_sd15.py's modules (pure
    torch, written from the diffusers spec, not from either package's
    mappers) built on the meta device."""
    from tests import torch_sd15

    with torch.device("meta"):
        mods = {"unet": torch_sd15.UNet2DConditionModel(),
                "openpose": torch_sd15.ControlNetModel(),
                "vae": torch_sd15.AutoencoderKL()}
    return {k: {n: tuple(v.shape) for n, v in m.state_dict().items()} for k, m in mods.items()}


def synth_on_card(manifest, gen, dtype):
    """Values for a manifest, drawn on the generator's device in sorted key
    order with tests/golden_mirror.py::synth_state_dict's scales: N(0,
    1/fan_in) for >= 2-D, 1 + 0.25 N(0, 1) for 1-D; position_ids 0..n-1."""
    out = {}
    for k in sorted(manifest):
        shape = manifest[k]
        if k.endswith("position_ids"):
            out[k] = torch.arange(shape[-1], device=gen.device).reshape(shape)
            continue
        x = torch.randn(shape, generator=gen, device=gen.device)
        x = x / math.sqrt(math.prod(shape[1:])) if len(shape) >= 2 else 1.0 + 0.25 * x
        out[k] = x.to(dtype)
    return out


def _finite_strings(pattern: str):
    """Every string a regex of literals, character classes, groups and
    alternations matches (a mapper rule's torch keys)."""
    from re import _constants as C, _parser as P

    def seq(items):
        outs = [""]
        for op, av in items:
            outs = [a + b for a in outs for b in one(op, av)]
        return outs

    def one(op, av):
        if op is C.LITERAL:
            return [chr(av)]
        if op is C.SUBPATTERN:
            return seq(av[3])
        if op is C.BRANCH:
            return [x for branch in av[1] for x in seq(branch)]
        if op is C.IN:
            out = []
            for o, a in av:
                if o is C.LITERAL:
                    out.append(chr(a))
                elif o is C.RANGE:
                    out += [chr(c) for c in range(a[0], a[1] + 1)]
                elif o is C.CATEGORY and a is C.CATEGORY_DIGIT:
                    out += list("0123456789")
                else:
                    raise ValueError(f"{pattern}: class item {o}")
            return out
        raise ValueError(f"{pattern}: not a finite pattern ({op})")

    return seq(P.parse(pattern))


def upstream_state_dict(tree, rules, rename=lambda path: path):
    """The upstream-keyed state dict that a port mapper (its KeyMapper
    ``rules``, then ``rename`` for the renaming it does after them) maps
    onto ``tree``: every key a rule matches, mapped alone, names the leaf it
    fills. SAM's four point-embedding rows and its (1, 256) embeddings,
    which the mapper reshapes, are split and reshaped back."""
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.core.porting import KeyMapper

    mapper = KeyMapper(rules)
    names = {}
    for pat, template, _ in mapper.rules:
        if template is not None:
            for key in _finite_strings(pat.pattern):
                names.setdefault(rename(mapper.match(key)[0]), []).append(key)
    out = {}
    for path, v in ((".".join(k), v) for k, v in flatten(tree).items()):
        keys = names.get(path, [])
        if path == "prompt_encoder.point_embeddings":
            out.update({f"{path}.{i}.weight": v[i:i + 1] for i in range(v.shape[0])})
        elif len(keys) != 1:
            fail(f"pretrained: no single upstream key for {path}: {keys[:3]}")
        elif path.endswith(("not_a_point_embed", "no_mask_embed")):
            out[keys[0]] = v[None]
        else:
            out[keys[0]] = v
    return out


def _sam_rename(path):
    pe = "prompt_encoder.point_embeddings"
    return pe if path.startswith(pe + ".") else path


def _pose_rename(path):
    return path[:-len(".weight")] + ".kernel" if path.endswith(".weight") else path


def _trees_equal(a, b, cast=None) -> bool:
    """Same keys and bitwise-equal values (b cast by ``cast(path, leaf)``
    first when given)."""
    from edgestyle_tpu_torch.core.params import flatten

    fa, fb = flatten(a), flatten(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k], cast(k, v) if cast else v) for k, v in fb.items())


def pretrained_phase(dev, card: str):
    """Full-width diffusers/HF files written by the port's own writer and
    read back through the port's loaders and its two entry points (module
    docstring, phase 8). Returns the kernels' launches of the try-on CLI's
    and the trainer's runs."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train, tryon
    from edgestyle_tpu_torch.core import pretrained
    from edgestyle_tpu_torch.core.params import flatten, unflatten
    from edgestyle_tpu_torch.core.porting import load_state_dict, tree_from_flat
    from edgestyle_tpu_torch.core.safetensors import save_file
    from edgestyle_tpu_torch.models.efficientvit.sam import SAM_L2, _sam_rules
    from edgestyle_tpu_torch.models.openpose import (
        BodyPoseNet,
        _bodypose_rules,
        port_bodypose_state_dict,
    )
    from edgestyle_tpu_torch.models.unet import controllora_params
    from edgestyle_tpu_torch.pipelines.preprocess import HEAD_NAMES, TryOnPreprocessor
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline, PipelineConfig
    from edgestyle_tpu_torch.training import checkpoint
    from edgestyle_tpu_torch.training.train_step import init_trainable

    rec = {"card": card, "models": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # 1. manifests, against the parameter-count anchors
    manifests = {**sd15_manifests(), "text_encoder": clip_text_manifest()}
    counts = {k: sum(math.prod(s) for n, s in m.items() if not n.endswith("position_ids"))
              for k, m in manifests.items()}
    rec["params"] = counts
    for k, want in PRETRAINED_ANCHORS.items():
        if counts[k] != want:
            fail(f"pretrained: the {k} manifest has {counts[k]:,} parameters, not {want:,}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pretrained_") as root:
        path = lambda *p: os.path.join(root, *p)  # noqa: E731

        def write(name, tensors, file_path):
            os.makedirs(os.path.dirname(file_path), exist_ok=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = save_file(tensors, file_path)
            dt = time.perf_counter() - t0
            m = rec["models"].setdefault(name, {"bytes": 0, "write_s": 0.0})
            m["bytes"] += n
            m["write_s"] += dt
            m["write_gb_s"] = m["bytes"] / m["write_s"] / 1e9

        # 2. the files
        spot = {}
        for name, (sub_dir, fname, dtype) in PRETRAINED_FILES.items():
            sd = synth_on_card(manifests[name], gen, dtype)
            if name == "unet":
                spot = {k: sd[k] for k in ("conv_in.weight", "conv_in.bias",
                                           "conv_norm_out.weight")}
            write(name, sd, path(sub_dir, fname))
            del sd
        pipe = EdgeStylePipeline(PipelineConfig(), device=dev)
        recorded = pipe.record_params()
        tr = init_trainable(pipe, gen, recorded["unet"], PRETRAINED_RANK, lora_conv_rank=1)
        tr = unflatten({k: (0.1 * torch.randn(v.shape, generator=gen, device=dev)).contiguous(
            memory_format=torch.channels_last if v.ndim == 4 else torch.contiguous_format)
            for k, v in flatten(tr).items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pretrained.export_reference_layout(
            path("trained"), tr, {"kernel": spot["conv_in.weight"], "bias": spot["conv_in.bias"]})
        rec["models"]["trained"] = {"bytes": sum(
            os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path("trained"))
            for f in fs), "write_s": time.perf_counter() - t0}
        rec["models"]["trained"]["write_gb_s"] = (rec["models"]["trained"]["bytes"]
                                                  / rec["models"]["trained"]["write_s"] / 1e9)
        pre = TryOnPreprocessor(SAM_L2, dtype=torch.bfloat16)
        sam_init = pre.init_params(gen)
        heads = {n: pre.sam.init_params(gen)["mask_decoder"] for n in HEAD_NAMES}
        sam_rules = _sam_rules(SAM_L2)
        write("sam_l2", upstream_state_dict(sam_init["sam"], sam_rules, _sam_rename),
              path("sam", "l2.safetensors"))
        for n, dec in heads.items():
            full = upstream_state_dict({"mask_decoder": dec}, sam_rules, _sam_rename)
            write("sam_l2", {k[len("mask_decoder."):]: v for k, v in full.items()},
                  path("sam", f"{n}.safetensors"))
        pose_init = BodyPoseNet().init_params(gen)
        write("bodypose", upstream_state_dict(pose_init, _bodypose_rules(), _pose_rename),
              path("bodypose.safetensors"))
        rec["bytes_written"] = sum(m["bytes"] for m in rec["models"].values())

        # 3. each loader alone, then the whole tree against init_params's
        def timed_load(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            m = rec["models"][name]
            m["load_s"] = time.perf_counter() - t0
            m["load_gb_s"] = m["bytes"] / m["load_s"] / 1e9
            return out

        dt = pipe.dtype
        timed_load("unet", lambda: pretrained.load_unet_params(path("pretrained/unet"), dev, dt))
        timed_load("text_encoder", lambda: pretrained.load_clip_text_params(
            path("pretrained/text_encoder"), 12, dev, dt))
        timed_load("vae", lambda: pretrained.load_vae_params(path("vae"), dev, dt))
        timed_load("openpose", lambda: pretrained.load_controlnet_params(path("openpose"), dev, dt))
        back = timed_load("trained", lambda: pretrained.load_edgestyle_pretrained_dir(
            path("trained"), dev))
        sam_back = timed_load("sam_l2", lambda: tryon._load_sam_params(
            pre, path("sam", "l2.safetensors"),
            {n: path("sam", f"{n}.safetensors") for n in HEAD_NAMES}, dev))
        pose_back = timed_load("bodypose", lambda: tree_from_flat(port_bodypose_state_dict(
            load_state_dict(path("bodypose.safetensors"), dev)), dev))
        if not _trees_equal(back, tr):
            fail("pretrained: the trained set does not read back bitwise")
        if not (_trees_equal(sam_back, {"sam": sam_init["sam"], "decoders": heads},
                             lambda k, v: v.float())
                and _trees_equal(pose_back, pose_init)):
            fail("pretrained: the SAM-L2 or body-pose file does not read back equal to the "
                 "port's init")
        del back, sam_back, pose_back, sam_init, heads, pose_init

        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = pretrained.load_pipeline_params(
            path("pretrained"), path("vae"), path("openpose"), path("trained"), pipe=pipe)
        torch.cuda.synchronize()
        rec["pipeline_load_s"] = time.perf_counter() - t0
        rec["device_memory_after_load_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        cn_rec = recorded["controlnet"]
        heads_rec = {k: v for k, v in cn_rec["static"].items() if k.startswith("controlnet_")}
        for g in sorted({g.params_key for g in pipe.mcn.groups if g.kind == "lora"}):
            cn_rec[g] = controllora_params(recorded["unet"], {}, heads_rec)
        want = {}

        def walk(node, prefix=()):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    want[prefix + (k,)] = (tuple(v.shape), node.rules[k][1])

        walk(recorded)
        got = flatten(params)
        if got.keys() != want.keys():
            fail(f"pretrained: the loaded tree's keys differ from init_params's: "
                 f"{sorted(set(got) ^ set(want))[:6]}")
        bad = [k for k, (shape, fp32) in want.items()
               if tuple(got[k].shape) != shape
               or got[k].dtype != (torch.float32 if fp32 else dt)
               or not got[k].is_contiguous(memory_format=torch.channels_last
                                           if got[k].ndim == 4 else torch.contiguous_format)]
        if bad:
            fail(f"pretrained: {len(bad)} leaves break the shape, dtype or layout rules: "
                 f"{bad[:4]}")
        cn = params["controlnet"]
        cast = lambda k, v: v.to(torch.float32 if "normalization" in k[-2] else dt)  # noqa: E731
        checks = {
            "unet conv_in is the file's, cast": torch.equal(
                params["unet"]["conv_in"]["kernel"], spot["conv_in.weight"].to(dt)),
            "unet conv_norm_out stays fp32": torch.equal(
                params["unet"]["conv_norm_out"]["scale"], spot["conv_norm_out.weight"].float()),
            "fusion is the trained set's, cast": _trees_equal(cn["fusion"], tr["fusion"], cast),
            "heads are the trained set's, cast": all(_trees_equal(
                {k: v for k, v in cn[f"lora_{i}"].items() if k.startswith("controlnet_")
                 and k != "controlnet_cond_embedding"}, tr[f"heads_{i}"], cast) for i in (0, 1)),
            "branches share the static cond embedding": all(
                cn[f"lora_{i}"]["controlnet_cond_embedding"] is
                cn["static"]["controlnet_cond_embedding"] for i in (0, 1)),
        }
        if not all(checks.values()):
            fail(f"pretrained: {[k for k, ok in checks.items() if not ok]}")
        rec["loaded_leaves"] = len(got)
        del params, got, pipe, recorded, tr, spot
        torch.cuda.empty_cache()

        # 4. photos -> try-on, the CLI without --random_init
        photos = []
        for i, ph in enumerate(make_photos(3, 3, 512)):
            photos.append(path(f"photo{i}.png"))
            Image.fromarray((ph * 255).astype(np.uint8)).save(photos[-1])
        argv = ["--subject", photos[0], "--clothes1", photos[1], "--clothes2", photos[2],
                "--pretrained_model", path("pretrained"), "--vae", path("vae"),
                "--openpose_controlnet", path("openpose"),
                "--edgestyle_checkpoint", path("trained"),
                "--sam_checkpoint", path("sam", "l2.safetensors"),
                "--bodypose_checkpoint", path("bodypose.safetensors"),
                "--out", path("result.png")]
        for n in HEAD_NAMES:
            argv += [f"--sam_{n}", path("sam", f"{n}.safetensors")]
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = tryon.main(argv, device=dev)
        torch.cuda.synchronize()
        rec["tryon_cli_s"] = time.perf_counter() - t0
        tryon_launches = dict(kernels.LAUNCHES)
        rec["tryon_launches"] = tryon_launches
        rec["image"] = {"shape": list(image.shape), "min": float(image.min()),
                        "max": float(image.max()), "mean": float(image.mean()),
                        "std": float(image.std())}
        if image.shape != (512, 512, 3) or not (np.isfinite(image).all() and image.min() >= 0
                                               and image.max() <= 1):
            fail(f"pretrained: the try-on CLI's image is not a finite [0, 1] 512 px image: "
                 f"{rec['image']}")
        if tryon_launches != GEN_LAUNCHES_PER_REQUEST:
            fail(f"pretrained: the try-on CLI's kernel launches {tryon_launches} differ from "
                 f"the generation's {GEN_LAUNCHES_PER_REQUEST}")
        torch.cuda.empty_cache()

        # 5. one training step from the same directories
        argv = ["--pretrained_model", path("pretrained"), "--vae", path("vae"),
                "--openpose_controlnet", path("openpose"), "--resolution", "512",
                "--train_batch_size", "1", "--gradient_accumulation_steps", "1",
                "--max_train_steps", "1", "--mixed_precision", "bf16", "--logging_steps", "1",
                "--seed", "0", "--output_dir", path("train_out")]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train.main(argv, device=dev)
        torch.cuda.synchronize()
        rec["train_cli_s"] = time.perf_counter() - t0
        train_launches = dict(kernels.LAUNCHES)
        rec["train_launches"] = train_launches
        rec["train_loss"] = [r["loss"] for r in res["log"]]
        rec["train_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        trained = res["state"]["trainable"]
        if not (_trees_equal(pretrained.load_edgestyle_pretrained_dir(
                path("train_out", "controlnet"), dev), trained)
                and _trees_equal(checkpoint.import_safetensors(
                    path("train_out", "edgestyle_trainable.safetensors"), dev), trained)):
            fail("pretrained: the trainer's exported trained set does not read back bitwise")
        del res, trained
        shutil.rmtree(path("train_out"), ignore_errors=True)
        if len(rec["train_loss"]) != 1 or not math.isfinite(rec["train_loss"][0]):
            fail(f"pretrained: the training step's loss is not one finite value: "
                 f"{rec['train_loss']}")
        if train_launches != TRAIN_LAUNCHES_PER_STEP:
            fail(f"pretrained: the training step's launches {train_launches} differ from "
                 f"{TRAIN_LAUNCHES_PER_STEP}")

    m = rec["models"]
    print(f"pretrained ({card}): wrote {rec['bytes_written'] / 1e9:.3f} GB; "
          + "; ".join(f"{k} {v['bytes'] / 1e9:.3f} GB written {v['write_s']:.3f} s "
                      f"({v['write_gb_s']:.2f} GB/s), loaded {v['load_s']:.3f} s "
                      f"({v['load_gb_s']:.2f} GB/s)" for k, v in m.items())
          + f"; load_pipeline_params {rec['pipeline_load_s']:.3f} s, "
            f"{rec['loaded_leaves']} leaves, device memory after it "
            f"{rec['device_memory_after_load_gib']:.2f} GiB; try-on CLI "
            f"{rec['tryon_cli_s']:.2f} s (image mean {rec['image']['mean']:.4f} std "
            f"{rec['image']['std']:.4f}, launches {rec['tryon_launches']}); trainer "
            f"{rec['train_cli_s']:.2f} s, loss {rec['train_loss']}, launches "
            f"{rec['train_launches']}", flush=True)
    print(json.dumps({"pretrained": rec}), flush=True)
    return tryon_launches, train_launches


# ------------------------------------------- CLIP, dataset and validation
# Parameters of the full-width dual-tower CLIPModel (openai/
# clip-vit-large-patch14: the text tower and ViT-L/14 with their projections
# and logit_scale), HF's own count.
CLIP_MODEL_PARAMS = 427_616_513
MINER_TIMED = 10


def clip_vision_manifest(layers=24, width=1024, mlp=4096, patch=14, image=224, projection=768):
    """Key -> shape of HF's CLIPVisionModelWithProjection (ViT-L/14 by
    default) in a CLIPModel file (``vision_model.*``, ``visual_projection``),
    from HF's key grammar, with the I64 position_ids buffer."""
    n = (image // patch) ** 2 + 1
    e = "vision_model.embeddings"
    m = {f"{e}.class_embedding": (width,), f"{e}.patch_embedding.weight": (width, 3, patch, patch),
         f"{e}.position_embedding.weight": (n, width), f"{e}.position_ids": (1, n),
         "visual_projection.weight": (projection, width)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        m[f"vision_model.{ln}.weight"], m[f"vision_model.{ln}.bias"] = (width,), (width,)
    for i in range(layers):
        p = f"vision_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m[f"{p}.self_attn.{proj}.weight"], m[f"{p}.self_attn.{proj}.bias"] = \
                (width, width), (width,)
        for ln in ("layer_norm1", "layer_norm2"):
            m[f"{p}.{ln}.weight"], m[f"{p}.{ln}.bias"] = (width,), (width,)
        m[f"{p}.mlp.fc1.weight"], m[f"{p}.mlp.fc1.bias"] = (mlp, width), (mlp,)
        m[f"{p}.mlp.fc2.weight"], m[f"{p}.mlp.fc2.bias"] = (width, mlp), (width,)
    return m


def clip_model_manifest(text=None, vision=None, projection=768):
    """Key -> shape of HF's dual-tower CLIPModel (openai's layout; the
    towers of clip-vit-large-patch14 unless ``text`` / ``vision`` give other
    sizes, as :func:`clip_text_manifest` and :func:`clip_vision_manifest`
    take them), with ``logit_scale``."""
    text = dict(text or {})
    return {**clip_text_manifest(**text), **clip_vision_manifest(**(vision or {}),
                                                                   projection=projection),
            "text_projection.weight": (projection, text.get("width", 768)), "logit_scale": ()}


def _captured(fn):
    """fn()'s result and its standard output, which is also printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def _logit_margin(logits) -> float:
    """The smaller of the gaps that decide a top-2 (first to second, second
    to third) of each row, in logit units."""
    top = torch.sort(logits, dim=-1, descending=True).values[:, :3]
    return float(torch.minimum(top[:, 0] - top[:, 1], top[:, 1] - top[:, 2]).min())


def write_clip_files(root: str, dev) -> dict:
    """A seeded full-width CLIPModel file (``root/clip``) and the byte
    tokenizer's files (``root/tokenizer``), which the mined_tryon and
    extract phases read: {clip_dir, tok_dir, params, file_bytes, write_s}."""
    from edgestyle_tpu_torch.core.safetensors import save_file
    from edgestyle_tpu_torch.data.tokenizer import make_byte_tokenizer

    manifest = clip_model_manifest()
    out = {"clip_dir": os.path.join(root, "clip"), "tok_dir": os.path.join(root, "tokenizer")}
    out["params"] = sum(math.prod(s) for k, s in manifest.items()
                        if not k.endswith("position_ids"))
    if out["params"] != CLIP_MODEL_PARAMS:
        fail(f"mined_tryon: the CLIPModel manifest has {out['params']:,} parameters, not "
             f"{CLIP_MODEL_PARAMS:,}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    os.makedirs(out["clip_dir"])
    sd = synth_on_card(manifest, gen, torch.float32)
    t0 = time.perf_counter()
    out["file_bytes"] = save_file(sd, os.path.join(out["clip_dir"], "model.safetensors"))
    out["write_s"] = time.perf_counter() - t0
    del sd
    make_byte_tokenizer().save_pretrained(out["tok_dir"])
    return out


def mined_tryon_phase(dev, card: str, clip_files: dict):
    """The try-on CLI with prompt mining at full width: ``clip_files``'
    seeded ViT-L/14 CLIPModel file and byte tokenizer
    (:func:`write_clip_files`), ``apps/tryon.py::main`` with ``--random_init
    --tokenizer_dir --clip_model`` on three photos, the mined prompt's form,
    the miner's time per image and its vision forward's share, and the
    card's image embedding against the CPU's. Returns the kernels' launches
    of the CLI run."""
    import tempfile

    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import tryon
    from edgestyle_tpu_torch.core.pretrained import load_clip_model_params
    from edgestyle_tpu_torch.data.prompts import (
        CLOTHING_ITEMS,
        COLORS,
        TRIGGER_WORD,
        build_prompt_miner,
        top2,
    )
    from edgestyle_tpu_torch.models.clip_vision import CLIPVisionModelWithProjection

    rec = {"card": card, **{k: clip_files[k] for k in ("params", "file_bytes", "write_s")}}
    clip_dir, tok_dir = clip_files["clip_dir"], clip_files["tok_dir"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mined_") as root:
        photos = []
        for i, ph in enumerate(make_photos(3, 3, 512)):
            photos.append(os.path.join(root, f"photo{i}.png"))
            Image.fromarray((ph * 255).astype(np.uint8)).save(photos[-1])
        argv = ["--subject", photos[0], "--clothes1", photos[1], "--clothes2", photos[2],
                "--random_init", "--tokenizer_dir", tok_dir, "--clip_model", clip_dir,
                "--out", os.path.join(root, "result.png")]
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image, out = _captured(lambda: tryon.main(argv, device=dev))
        torch.cuda.synchronize()
        rec["cli_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rec["launches"] = launches
        mined = [ln[len("mined prompt: "):] for ln in out.splitlines()
                 if ln.startswith("mined prompt: ")]
        if len(mined) != 1:
            fail(f"mined_tryon: the CLI printed {len(mined)} mined prompts")
        prompt = rec["prompt"] = mined[0]
        terms = prompt[len(TRIGGER_WORD) + 2:].split(", ")
        if not (prompt.startswith(f"{TRIGGER_WORD}, ") and len(terms) == 4
                and terms[0] in COLORS and terms[1] in COLORS
                and terms[2] in CLOTHING_ITEMS and terms[3] in CLOTHING_ITEMS):
            fail(f"mined_tryon: the mined prompt {prompt!r} is not 'edgestyle, ' and two "
                 f"colours and two garments")
        check_images(torch.from_numpy(image).permute(2, 0, 1)[None], 1, "mined_tryon")
        if launches != GEN_LAUNCHES_PER_REQUEST:
            fail(f"mined_tryon: the CLI's launches {launches} differ from the generation's "
                 f"{GEN_LAUNCHES_PER_REQUEST}")
        torch.cuda.empty_cache()

        # the miner alone, B=1, on the first garment photo as main gives it
        t0 = time.perf_counter()
        miner = build_prompt_miner(tok_dir, clip_dir, device=dev)
        torch.cuda.synchronize()
        rec["miner_build_s"] = time.perf_counter() - t0
        c1 = tryon.load_image_512(photos[1]).astype(np.float32)[None] / 255.0
        miner(c1)
        rec["miner_ms"] = 1e3 * _wall(lambda: miner(c1), MINER_TIMED)[0]
        px = miner.pixel_values(c1)
        with torch.no_grad():
            rec["vision_ms"] = 1e3 * _wall(lambda: miner.best.encode_image(px), MINER_TIMED)[0]
        rec["vision_share"] = rec["vision_ms"] / rec["miner_ms"]
        if miner(c1) != [prompt]:
            fail("mined_tryon: the miner alone mines another prompt than the CLI's")

        # the same vision tower on the CPU, fp32, TF32 off, same pixels
        vision_cpu = load_clip_model_params(clip_dir, device="cpu")["vision"]
        tower = CLIPVisionModelWithProjection()
        with torch.no_grad():
            emb_card = miner.best.encode_image(px).float()
            emb_cpu = tower(vision_cpu, px.cpu())["image_embeds"].float()
        rec["image_embeds_max_abs_err"] = float((emb_card.cpu() - emb_cpu).abs().max())
        banks = {"colors": miner.best.color_bank.float(), "items": miner.best.item_bank.float()}
        logit = lambda e, bank: 100.0 * (e / e.norm(dim=-1, keepdim=True)) @ bank.T  # noqa: E731
        rec["banks"], cpu_terms = {}, []
        for j, (name, bank) in enumerate(banks.items()):
            lc, lh = logit(emb_card, bank).cpu(), logit(emb_cpu, bank.cpu())
            words = COLORS if name == "colors" else CLOTHING_ITEMS
            cpu_terms += [words[i] for i in top2(torch.softmax(lh, dim=-1))[0].tolist()]
            rec["banks"][name] = {"top2_margin": _logit_margin(lc),
                                  "logit_max_abs_err": float((lc - lh).abs().max()),
                                  "same_terms": cpu_terms[2 * j:] == terms[2 * j:2 * j + 2]}
        rec["cpu_prompt"] = f"{TRIGGER_WORD}, " + ", ".join(cpu_terms)
        del miner, vision_cpu
    torch.cuda.empty_cache()

    b = rec["banks"]
    print(f"mined_tryon ({card}): CLIPModel file {rec['file_bytes'] / 1e9:.3f} GB "
          f"({rec['params']:,} parameters, fp32) written in {rec['write_s']:.2f} s; try-on CLI "
          f"with mining {rec['cli_s']:.2f} s, mined prompt {prompt!r}, launches {launches}; "
          f"miner build {rec['miner_build_s']:.2f} s; miner {rec['miner_ms']:.2f} ms per image "
          f"(B=1, median of {MINER_TIMED}), vision forward {rec['vision_ms']:.2f} ms "
          f"({100 * rec['vision_share']:.1f}%); image_embeds card vs CPU max |diff| "
          f"{rec['image_embeds_max_abs_err']:.3e}; top-2 logit margins colours "
          f"{b['colors']['top2_margin']:.4f} / items {b['items']['top2_margin']:.4f} against "
          f"logit errors {b['colors']['logit_max_abs_err']:.3e} / "
          f"{b['items']['logit_max_abs_err']:.3e}; CPU prompt {rec['cpu_prompt']!r}", flush=True)
    print(json.dumps({"mined_tryon": rec}), flush=True)
    if any(not v["same_terms"] and v["top2_margin"] > v["logit_max_abs_err"]
           for v in b.values()):
        fail("mined_tryon: the CPU's tower picks other terms from a bank whose top-2 margin "
             "exceeds the card's error")
    return launches


DATA_SUBJECTS, DATA_FRAMES = ("s0", "s1"), ("f0", "f1", "f2")
DATA_TRAIN_STEPS = 3
DATA_VALIDATION_STEPS = 2
DATA_VALIDATION_IMAGES = 2
VALIDATION_STEPS = 8  # the trainer's validation runs 8 denoise steps
# Launches per guidance scale of a validation, from the code: 8 denoise
# steps of the generation's 22 flash and 104 GN statistics / conv launches,
# plus the VAE's 48 (the three VAE conds encoded, the images decoded).
VALIDATION_LAUNCHES_PER_SCALE = {"flash_fwd": 22 * VALIDATION_STEPS,
                                 "gn_scale_shift": 104 * VALIDATION_STEPS + 2 * (10 + 14),
                                 "fused_gn_silu_conv3x3": 104 * VALIDATION_STEPS + 2 * (10 + 14),
                                 "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def write_dataset(root: str) -> None:
    """The extracted dataset's layout: DATA_SUBJECTS x DATA_FRAMES x the six
    artifact folders, seeded 512 px JPEGs (12 index triples)."""
    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch.data.dataset import ARTIFACTS

    photos = iter(make_photos(11, len(DATA_SUBJECTS) * len(DATA_FRAMES) * len(ARTIFACTS), 512))
    for s in DATA_SUBJECTS:
        for a in ARTIFACTS:
            os.makedirs(os.path.join(root, s, a))
            for f in DATA_FRAMES:
                Image.fromarray((next(photos) * 255).astype(np.uint8)).save(
                    os.path.join(root, s, a, f + ".jpg"))


def data_training_phase(dev, card: str, synthetic_step_s: float):
    """The trainer's entry point on a dataset at full width (module
    docstring, phase 9): the loader's host time, 3 steps with 2 workers and
    prefetch, validation in the app where tensorboardX is installed, the
    training phase's checks and launch counts. Returns (launches, (pipe,
    frozen, trainable, first micro-batch)) for the validation phase."""
    import shutil
    import tempfile

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.data.dataset import EdgeStyleLocalDataset, data_loader
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    rec = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as root:
        data_dir = os.path.join(root, "data")
        t0 = time.perf_counter()
        write_dataset(data_dir)
        rec["write_s"] = time.perf_counter() - t0
        ds = EdgeStyleLocalDataset(data_dir)
        rec["index"] = len(ds)
        if len(ds) != 12:
            fail(f"data_training: the dataset indexes {len(ds)} triples, not 12")
        rec["loader_s_per_batch"] = {}
        for workers in (0, 2):
            it = data_loader(ds, 2, 1, seed=0, num_workers=workers)
            next(it)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                next(it)
                times.append(time.perf_counter() - t0)
            rec["loader_s_per_batch"][workers] = statistics.median(times)

        out_dir = os.path.join(root, "out")
        argv = ["--random_init", "--dataset_dir", data_dir, "--resolution", "512",
                "--train_batch_size", "2", "--gradient_accumulation_steps", "1",
                "--max_train_steps", str(DATA_TRAIN_STEPS), "--dataloader_num_workers", "2",
                "--validation_steps", str(DATA_VALIDATION_STEPS),
                "--num_validation_images", str(DATA_VALIDATION_IMAGES),
                "--mixed_precision", "bf16", "--logging_steps", "1", "--seed", "0",
                "--output_dir", out_dir]
        for k in train.PROPORTIONS:
            argv += [f"--{k}", "0.2"]
        args = train.parse_args(argv)
        writer = train.summary_writer(args)
        rec["tensorboardX"] = writer is not None
        if writer is not None:
            writer.close()
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train.main(argv, device=dev)
        torch.cuda.synchronize()
        rec["main_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rec["launches"] = launches

        log = res["log"]
        if [r["step"] for r in log] != list(range(1, DATA_TRAIN_STEPS + 1)):
            fail(f"data_training: logged steps {[r['step'] for r in log]}")
        losses, ds_ = [r["loss"] for r in log], [r["d"] for r in log]
        if not all(math.isfinite(x) for x in losses):
            fail(f"data_training: non-finite loss {losses}")
        if not all(b >= a for a, b in zip(ds_, ds_[1:])):
            fail(f"data_training: Prodigy's d fell: {ds_}")
        ends = [0.0] + [r["elapsed_s"] for r in log]
        step_s = [b - a for a, b in zip(ends, ends[1:])]
        # the app validates after logging step 2, inside step 3's interval
        steady = step_s[1] if rec["tensorboardX"] else sum(step_s[1:]) / len(step_s[1:])
        rec.update(losses=losses, d=ds_, step_s=step_s, steady_s_per_step=steady,
                   synthetic_steady_s_per_step=synthetic_step_s)

        built = train.build(args, dev)
        pipe, frozen0, _, state0, _ = built
        init, final = flatten(state0["trainable"]), flatten(res["state"]["trainable"])
        for group in TRAINABLE_GROUPS:
            if not any(not torch.equal(final[k], v) for k, v in init.items() if k[0] == group):
                fail(f"data_training: trainable group {group} did not move")
        frozen = flatten(res["frozen"])
        if frozen.keys() != flatten(frozen0).keys() or not all(
                torch.equal(frozen[k], v) for k, v in flatten(frozen0).items()):
            fail("data_training: a frozen weight changed in training")
        del built, state0, frozen0, init, final, frozen

        n_val = DATA_TRAIN_STEPS // DATA_VALIDATION_STEPS if rec["tensorboardX"] else 0
        want = {k: v * DATA_TRAIN_STEPS + n_val * DATA_VALIDATION_IMAGES
                * VALIDATION_LAUNCHES_PER_SCALE[k] for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
        rec["predicted_launches"] = want
        first = next(train.dataset_loader(args))
        batch = {k: torch.from_numpy(v[0]).to(dev) for k, v in first.items()}
        shutil.rmtree(out_dir, ignore_errors=True)

    lp = rec["loader_s_per_batch"]
    print(f"data_training ({card}): dataset of {rec['index']} triples written in "
          f"{rec['write_s']:.2f} s; loader host s/batch (micro-batch 2, 512 px) {lp[0]:.4f} at "
          f"0 workers, {lp[2]:.4f} at 2; train.main on the dataset ({DATA_TRAIN_STEPS} steps, "
          f"2 workers + prefetch, validation every {DATA_VALIDATION_STEPS} steps) "
          f"{rec['main_s']:.2f} s, losses {losses}, d {ds_}, seconds per step "
          f"{[round(x, 4) for x in step_s]}, steady {steady:.4f} s/step against the synthetic "
          f"loader's {synthetic_step_s:.4f}; tensorboardX found: {rec['tensorboardX']} (the "
          f"app's validation {'ran' if rec['tensorboardX'] else 'skipped'}); launches "
          f"{launches}, predicted {want}", flush=True)
    print(json.dumps({"data_training": rec}), flush=True)
    if launches != want:
        fail("data_training: the kernel launches differ from the counts the code predicts")
    return launches, (pipe, res["frozen"], res["state"]["trainable"], batch)


class _TimedPipe:
    """A pipeline whose calls are timed on the host, each ending in a
    synchronize (``log_validation`` reads ``device`` and calls it)."""

    def __init__(self, pipe):
        self.pipe, self.device, self.seconds = pipe, pipe.device, []

    def __call__(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.pipe(*a, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def validation_phase(dev, card: str, trained):
    """``training/validation.py::log_validation`` on the card at 512 px on
    the data_training run's trained state and first micro-batch (b = 2),
    the four default guidance scales, 8 steps: the grid's shape and range,
    the launches against the prediction, each scale's seconds."""
    import numpy as np

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.training.validation import (
        VALIDATION_GUIDANCE_SCALES,
        log_validation,
    )

    pipe, frozen, trainable, batch = trained
    b = DATA_VALIDATION_IMAGES
    micro = {k: v[:b] for k, v in batch.items()}
    timed = _TimedPipe(pipe)
    n = len(VALIDATION_GUIDANCE_SCALES)
    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = log_validation(timed, frozen, trainable, micro, DATA_TRAIN_STEPS,
                          num_inference_steps=VALIDATION_STEPS)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {k: v * n for k, v in VALIDATION_LAUNCHES_PER_SCALE.items()}
    rec = {"card": card, "grid_shape": list(grid.shape), "wall_s": wall,
           "s_per_guidance_scale": dict(zip(map(str, VALIDATION_GUIDANCE_SCALES), timed.seconds)),
           "launches": launches, "predicted_launches": want,
           "grid_min": float(grid.min()), "grid_max": float(grid.max())}
    print(f"validation ({card}): log_validation at 512 px, b = {b}, guidance "
          f"{VALIDATION_GUIDANCE_SCALES}, {VALIDATION_STEPS} steps: {wall:.2f} s, seconds per "
          f"scale {[round(s, 3) for s in timed.seconds]}; grid {grid.shape} in "
          f"[{rec['grid_min']:.4f}, {rec['grid_max']:.4f}]; launches {launches}, predicted "
          f"{want}", flush=True)
    print(json.dumps({"validation": rec}), flush=True)
    if grid.shape != ((3 + n) * 512, b * 512, 3) or not np.isfinite(grid).all() or (
            grid.min() < 0 or grid.max() > 1):
        fail(f"validation: the grid {grid.shape} is not finite in [0, 1] of shape "
             f"({(3 + n) * 512}, {b * 512}, 3)")
    if launches != want:
        fail("validation: the kernel launches differ from the counts the code predicts")
    return launches


# ---------------------------------------------------------------- distill
DISTILL_ARGV = ["--random_init", "--resolution", "512", "--train_batch_size", "2",
                "--gradient_accumulation_steps", "1", "--lora_rank", "64",
                "--mixed_precision", "bf16", "--logging_steps", "1", "--seed", "0"]
DISTILL_STEPS = 3
DISTILL_EMA = 0.95


def distill_launches(mcn_calls: int, unet_calls: int) -> dict:
    """The kernels' launches of one distill step at micro-batch 2, from the
    code: the VAE encoder twice (the image, then the three VAE conds; 10
    ResNet blocks each), ``mcn_calls`` MultiControlNet calls (the teacher's
    CFG pair, and in consistency mode the target's; three trunk calls each)
    and ``unet_calls`` UNet calls (the student, the teacher and in
    consistency mode the target), their forward kernels at STEP_PARTS'
    counts; the flash backward only in the student, whose every long
    self-attention (down and up blocks, 10) needs dQ, dK and dV: its q, k
    and v projections carry adapters."""
    flash = mcn_calls * STEP_PARTS["trunks"]["flash_fwd"] + (
        unet_calls * STEP_PARTS["unet"]["flash_fwd"])
    conv = 2 * 2 * 10 + mcn_calls * STEP_PARTS["trunks"]["conv"] + (
        unet_calls * STEP_PARTS["unet"]["conv"])
    return {"flash_fwd": flash, "gn_scale_shift": conv, "fused_gn_silu_conv3x3": conv,
            "flash_bwd_dq": 10, "flash_bwd_dkv": 10}


DISTILL_LAUNCHES_PER_STEP = {"consistency": distill_launches(2, 3),
                             "guidance": distill_launches(1, 2)}


def distill_out_dir() -> str:
    """Checkpoints and exports of the distill phase, inside the checkout
    (git-ignored)."""
    return os.path.join(HERE, "build", "torch_ext", "chip_smoke_distill")


def _distill_run(dev, argv, steps: int, mode: str, rec: dict, name: str):
    """``apps/distill.py::main`` once, with the launches and the peak
    memory read around it alone, held against ``steps`` steps of the
    mode's prediction; the per-step seconds (the first includes the
    warm-up) into rec[name]."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import distill

    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = distill.main(argv, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = [r["loss"] for r in res["log"]]
    ends = [0.0] + [r["elapsed_s"] for r in res["log"]]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    want = {k: v * steps for k, v in DISTILL_LAUNCHES_PER_STEP[mode].items()}
    rec[name] = {"mode": mode, "steps": [r["step"] for r in res["log"]], "losses": losses,
                 "step_s": step_s, "main_wall_s": wall,
                 "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
                 "launches": launches, "predicted_launches": want}
    r = rec[name]
    print(f"distill {name} ({mode}, micro-batch 2, 512 px, rank 64, bf16): steps {r['steps']}, "
          f"losses {losses}; seconds between log lines {[round(x, 4) for x in step_s]} (the "
          f"first includes the warm-up, a line after a checkpoint step its save); main() wall "
          f"{wall:.2f} s (build and checkpoints included); peak device memory of main() "
          f"{r['peak_gib']:.2f} GiB above the {before / 2 ** 30:.2f} GiB held before it; "
          f"launches {launches}, predicted {want}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"distill {name}: non-finite loss {losses}")
    if launches != want:
        fail(f"distill {name}: the kernel launches differ from the counts the code predicts")
    return res, launches


DISTILL_TIMED = 3


def _distill_inputs(dev, pipe, frozen, argv):
    """(distill config, one synthetic batch, the empty prompt's context)
    for the distiller's flags ``argv``, as ``apps/distill.py::main`` makes
    them."""
    from edgestyle_tpu_torch.apps import distill, train
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

    args = distill.parse_args(argv)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.synthetic_loader(args)).items()}
    with torch.no_grad():
        uctx = pipe.clip(frozen["clip"], torch.from_numpy(empty_prompt_ids()).long().to(dev))[
            "last_hidden_state"]
    return distill.distill_config(args), batch, uctx


def _steady_step_s(dev, pipe, frozen, state0, argv) -> float:
    """Median seconds of DISTILL_TIMED steps of the step function ``main``
    runs (``make_distill_step`` of ``argv``'s config; each step ending on
    the host, as main's log line does), after one warm-up, on a synthetic
    micro-batch of 2 from the initial state: the steady step without the
    checkpoints that main's log lines include."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.training.distill import make_distill_step, sample_distill_draws

    dcfg, batch, uctx = _distill_inputs(dev, pipe, frozen, argv)
    state = {k: v for k, v in state0.items() if k != "target" or dcfg.ema_decay is not None}
    step = make_distill_step(pipe, dcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    def one():
        return float(step(state, frozen, batch, uctx,
                          sample_distill_draws(pipe, dcfg, batch, gen))[1]["loss"])

    one()
    s = _wall(one, DISTILL_TIMED)[0]
    kernels.reset_launches()
    return s


def distill_phase(dev, card: str):
    """The LCM-LoRA distiller's entry point at full width (SD1.5, 512 px,
    bf16, rank 64, micro-batch 2) from ``--random_init`` on the synthetic
    loader: run 1, consistency mode with an EMA target, DISTILL_STEPS steps,
    a checkpoint every 2; run 2, one more step resumed from the latest
    checkpoint; run 3, guidance mode (w pinned at 4), DISTILL_STEPS steps
    with a checkpoint each. Held: finite losses; the launches of every run
    against the prediction; after guidance step 1 every up has moved off
    zero and no down has moved (its gradient is zero while the ups are),
    after step 2 (of either mode) every down has moved; the EMA target at
    step 3 is d * target_2 + (1 - d) * online_3 and lies between its start
    and the online adapters; the frozen weights are unchanged; the
    checkpoints read back equal; the resumed run starts at step 3;
    ``lcm_lora.safetensors`` reads back bitwise. The steady s/step of each
    mode is timed on the step function alone (:func:`_steady_step_s`).
    Returns (launches by run,
    the path of run 1's ``lcm_lora.safetensors``, (pipe, frozen, initial
    state) rebuilt by ``build`` for the checks)."""
    import shutil

    from edgestyle_tpu_torch.apps import distill
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.training import checkpoint

    out_dir, g_dir = distill_out_dir(), distill_out_dir() + "_guidance"
    for d in (out_dir, g_dir):
        shutil.rmtree(d, ignore_errors=True)
    rec, launches = {"card": card}, {}
    argv1 = DISTILL_ARGV + ["--distill_mode", "consistency", "--ema_decay", str(DISTILL_EMA),
                            "--checkpointing_steps", "2", "--output_dir", out_dir]
    res1, launches["distill_consistency"] = _distill_run(
        dev, argv1 + ["--max_train_steps", str(DISTILL_STEPS)], DISTILL_STEPS, "consistency",
        rec, "consistency")
    lcm_file = os.path.join(out_dir, "lcm_lora_run1.safetensors")
    shutil.copy(os.path.join(out_dir, "lcm_lora.safetensors"), lcm_file)
    if not checkpoint.states_equal(checkpoint.import_safetensors(lcm_file, dev)["lcm_lora"],
                                   res1["state"]["lcm_lora"]):
        fail("distill: lcm_lora.safetensors does not read back equal to the adapters")
    res2, launches["distill_resume"] = _distill_run(
        dev, argv1 + ["--max_train_steps", str(DISTILL_STEPS + 1), "--resume_from_checkpoint",
                      "latest"], 1, "consistency", rec, "resume")
    if rec["resume"]["steps"] != [DISTILL_STEPS + 1] or res2["state"]["step"] != (
            DISTILL_STEPS + 1):
        fail(f"distill: the resumed run logged steps {rec['resume']['steps']}, not one step "
             f"from step {DISTILL_STEPS}")
    res3, launches["distill_guidance"] = _distill_run(
        dev, DISTILL_ARGV + ["--distill_mode", "guidance", "--w_min", "4", "--max_train_steps",
                             str(DISTILL_STEPS), "--checkpointing_steps", "1",
                             "--output_dir", g_dir], DISTILL_STEPS, "guidance", rec, "guidance")
    for name, res in (("consistency", res1), ("guidance", res3)):
        if rec[name]["steps"] != list(range(1, DISTILL_STEPS + 1)):
            fail(f"distill {name}: logged steps {rec[name]['steps']}")

    t0 = time.perf_counter()
    pipe, frozen0, _, state0 = distill.build(distill.parse_args(argv1), dev)
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    for mode, flags in (("consistency", argv1), ("guidance", DISTILL_ARGV + [
            "--distill_mode", "guidance", "--w_min", "4"])):
        rec[mode]["steady_s_per_step"] = _steady_step_s(dev, pipe, frozen0, state0, flags)
    init = flatten(state0["lcm_lora"])
    ups = [k for k in init if k[-1] == "up"]
    downs = [k for k in init if k[-1] == "down"]
    rec["adapters"] = {"leaves": len(init), "params": sum(v.numel() for v in init.values())}
    g1 = flatten(checkpoint.load_checkpoint(g_dir, 1, dev)["lcm_lora"])
    if any(g1[k].abs().max().item() == 0 for k in ups):
        fail("distill: an up adapter did not move off zero in the first step")
    if not all(torch.equal(g1[k], init[k]) for k in downs):
        fail("distill: a down adapter moved in the first step, where its gradient is zero")
    for name, root in (("consistency", out_dir), ("guidance", g_dir)):
        s2 = flatten(checkpoint.load_checkpoint(root, 2, dev)["lcm_lora"])
        if any(torch.equal(s2[k], init[k]) for k in downs):
            fail(f"distill {name}: a down adapter did not move by step 2")
    # the EMA target: the step's recurrence, and between its start and the online adapters
    s2 = checkpoint.load_checkpoint(out_dir, 2, dev)
    s3 = checkpoint.load_checkpoint(out_dir, DISTILL_STEPS, dev)
    if not checkpoint.states_equal(s3, res1["state"]):
        fail("distill: the final checkpoint does not read back equal to the distilled state")
    t2, t3, on3 = flatten(s2["target"]), flatten(s3["target"]), flatten(s3["lcm_lora"])
    ema_err = max((t3[k] - (DISTILL_EMA * t2[k] + (1 - DISTILL_EMA) * on3[k])).abs().max().item()
                  for k in t3)
    def moved(a):
        return math.sqrt(sum((a[k] - init[k]).square().sum().item() for k in init))

    rec["ema"] = {"recurrence_max_abs_err": ema_err,
                  "target_over_online_distance": moved(t3) / moved(on3)}
    if ema_err > 1e-6 or not 0 < rec["ema"]["target_over_online_distance"] < 1:
        fail(f"distill: the EMA target is not d * target + (1 - d) * online between its start "
             f"and the online adapters: {rec['ema']}")
    for name, res in (("consistency", res1), ("guidance", res3)):
        frozen = flatten(res["frozen"])
        if frozen.keys() != flatten(frozen0).keys() or not all(
                torch.equal(frozen[k], v) for k, v in flatten(frozen0).items()):
            fail(f"distill {name}: a frozen weight changed")
    rec["frozen_leaves"] = len(flatten(frozen0))
    print(f"distill checks: {rec['adapters']['leaves']} adapter leaves "
          f"({rec['adapters']['params']:,} parameters); guidance step 1 moved every up and no "
          f"down, step 2 every down (both modes); EMA recurrence max |err| {ema_err:.3e}, "
          f"target / online distance from the start {rec['ema']['target_over_online_distance']:.4f}"
          f"; frozen weights unchanged ({rec['frozen_leaves']} leaves); checkpoints and "
          f"lcm_lora.safetensors read back equal; rebuild {rec['build_s']:.2f} s; steady "
          f"s/step (make_distill_step alone, median of {DISTILL_TIMED} after a warm-up) "
          f"consistency {rec['consistency']['steady_s_per_step']:.4f}, guidance "
          f"{rec['guidance']['steady_s_per_step']:.4f}", flush=True)
    print(json.dumps({"distill": rec}), flush=True)
    shutil.rmtree(g_dir, ignore_errors=True)
    del res1, res2, res3, s2, s3
    return launches, lcm_file, (pipe, frozen0, state0)


DISTILL_GROUPS = ("down_blocks", "mid_block", "up_blocks", "time_embedding")


def distill_grad_check_phase(dev, built):
    """One consistency micro-batch at B=1 and full width, the adapters'
    ups given small random values (so every down's gradient is live): the
    LCM-LoRA gradients through the kernels and through the ops' plain
    versions, each adapter group (down blocks, mid block, up blocks, time
    embedding) within GRAD_TOL relative L2 and each leaf within LEAF_TOL;
    then a planted dq = 0 fault, which the same check must reject."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.core.params import flatten, unflatten
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv
    from edgestyle_tpu_torch.training import distill

    pipe, frozen, state = built
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    lora = {}
    for k, v in flatten(state["lcm_lora"]).items():
        if k[-1] == "up":
            v = torch.randn(v.shape, generator=gen, device=dev) * (0.3 / math.sqrt(v.shape[1]))
        lora[k] = v.clone()
    cfg, batch, uctx = _distill_inputs(dev, pipe, frozen,
                                       DISTILL_ARGV + ["--train_batch_size", "1"])
    draws = distill.sample_distill_draws(pipe, cfg, batch, gen)[0]
    mb = {k: v[0] for k, v in batch.items()}
    sched = distill.SCHEDULE.to(dev)

    def loss_and_grads():
        leaves = {k: v.detach().requires_grad_(True) for k, v in lora.items()}
        loss = distill.distill_loss_fn(unflatten(leaves), None, frozen, pipe, sched, cfg, mb,
                                       uctx, draws)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), {(next(g for g in DISTILL_GROUPS if k[0].startswith(g)),) + k: v
                             for k, v in zip(leaves, grads)}

    kernels.reset_launches()
    loss_k, g_k = loss_and_grads()
    launched = dict(kernels.LAUNCHES)
    if not all(launched.values()):
        fail(f"the distill gradient check's kernel run missed a kernel: {launched}")
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        kernels.reset_launches()
        loss_p, g_p = loss_and_grads()
        torch.cuda.synchronize()
        if any(kernels.LAUNCHES.values()):
            fail("the distill gradient check's plain run launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    dq_kernel = flash.flash_bwd_dq_cuda
    flash.flash_bwd_dq_cuda = lambda *a: dq_kernel(*a).zero_()
    try:
        g_fault = loss_and_grads()[1]
    finally:
        flash.flash_bwd_dq_cuda = dq_kernel
    kernels.reset_launches()
    print(f"distill gradient check (consistency, B=1, one micro-batch, bf16, rank 64): loss "
          f"through the kernels {loss_k:.6f}, through the plain versions {loss_p:.6f}; kernel "
          f"launches {launched}", flush=True)
    ok = {}
    for what, g in (("kernels", g_k), ("planted fault dq = 0", g_fault)):
        per_group, (key, leaf_rel, leaf_norm) = _grad_diffs(g, g_p, DISTILL_GROUPS)
        print(f"  {what} vs plain: relative L2 difference per adapter group (tol {GRAD_TOL}) "
              + ", ".join(f"{grp} {r:.3e} (|g_plain|_2 {n:.3e})"
                          for grp, (r, n) in per_group.items())
              + f"; worst leaf {'/'.join(map(str, key[1:])) if key else '-'} {leaf_rel:.3e} "
              f"(tol {LEAF_TOL}; |g_plain|_2 {leaf_norm:.3e})", flush=True)
        ok[what] = all(r <= GRAD_TOL for r, _ in per_group.values()) and leaf_rel <= LEAF_TOL
    if not ok["kernels"]:
        fail("LCM-LoRA gradients through the kernels and the plain versions disagree")
    if ok["planted fault dq = 0"]:
        fail("the distill gradient check passed a planted fault dq = 0")


def lcm_serving_phase(dev, card: str, lcm_file: str):
    """``apps/tryon.py::main --random_init --mode lcm --lcm_lora`` on the
    distill phase's adapters and three 512 px photos made with numpy: a
    finite [0, 1] image with the lcm preset's launches (4 steps, CFG off);
    then the same TryOnSystem's request time (one warm-up, SERVING_TIMED
    timed). Returns the CLI's launches."""
    import tempfile

    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import tryon
    from edgestyle_tpu_torch.data.tokenizer import empty_prompt_ids

    want = serving_launches(*SERVING_RUNS["lcm"][1:])
    rec = {"card": card, "predicted_launches": want}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lcm_") as root:
        photos = make_photos(4, 3, 512)
        paths = []
        for i, ph in enumerate(photos):
            paths.append(os.path.join(root, f"photo{i}.png"))
            Image.fromarray((ph * 255).astype(np.uint8)).save(paths[-1])
        argv = ["--subject", paths[0], "--clothes1", paths[1], "--clothes2", paths[2],
                "--random_init", "--mode", "lcm", "--lcm_lora", lcm_file,
                "--out", os.path.join(root, "result.png")]
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image = tryon.main(argv, device=dev)
        torch.cuda.synchronize()
        rec["cli_s"] = time.perf_counter() - t0
        launches = rec["launches"] = dict(kernels.LAUNCHES)
        check_images(torch.from_numpy(image).permute(2, 0, 1)[None], 1, "lcm_serving")
        system = tryon.TryOnSystem(random_init=True, args=tryon.parse_args(argv), device=dev)
        subject, c1, c2 = (tryon.load_image_512(p).astype(np.float32) / 255.0 for p in paths)
        ids = empty_prompt_ids()
        request = lambda: system(subject, c1, c2, ids, ids, 4, 3.5, 0)  # noqa: E731
        request()
        rec["request_s"], again = _wall(request, SERVING_TIMED)
        rec["request_equals_cli"] = bool(np.array_equal(again, image))
        del system
    torch.cuda.empty_cache()
    print(f"lcm_serving ({card}): try-on CLI --mode lcm --lcm_lora (the distill phase's rank-64 "
          f"adapters, 4 steps, CFG off) {rec['cli_s']:.2f} s with the init; request "
          f"{rec['request_s']:.4f} s (median of {SERVING_TIMED}, photos -> image); image equal "
          f"to the CLI's: {rec['request_equals_cli']}; launches {launches}, predicted {want}",
          flush=True)
    print(json.dumps({"lcm_serving": rec}), flush=True)
    if launches != want:
        fail("lcm_serving: the kernel launches differ from the lcm preset's prediction")
    return launches


def write_artifact_dirs(root: str):
    """Three artifact directories of the reference's layout, <root>/<s, c1,
    c2>/{subject, head, openpose, clothes}/0.png, 512 px images made with
    numpy; returns the infer flags that address them."""
    import numpy as np
    from PIL import Image

    photos = iter(make_photos(5, 12, 512))
    for base in ("s", "c1", "c2"):
        for sub in ("subject", "head", "openpose", "clothes"):
            os.makedirs(os.path.join(root, base, sub), exist_ok=True)
            Image.fromarray((next(photos) * 255).astype(np.uint8)).save(
                os.path.join(root, base, sub, "0.png"))
    return ["--source_path", os.path.join(root, "s"), "--source_image_name", "0.png",
            "--target_path", os.path.join(root, "c1"), "--target_image_name", "0.png",
            "--target_path2", os.path.join(root, "c2"), "--target_image_name2", "0.png"]


def infer_phase(dev, card: str):
    """``apps/infer.py::main --random_init`` on three artifact directories
    at full width: one image at 20 steps (a finite [0, 1] generation, the
    PNG its uint8 image, the generation's launches), then a
    ``--guidance_sweep --steps 4`` grid of (1536, 1536, 3): the three source
    photos and six generations, each finite in [0, 1], with six 4-step
    generations' launches. Returns the launches of both runs."""
    import tempfile

    import numpy as np
    from PIL import Image

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import infer
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    call = EdgeStylePipeline.__call__
    outs = []

    def recorded(self, *a, **kw):
        out = call(self, *a, **kw)
        outs.append(out.float().cpu())
        return out

    sweep_want = {k: 6 * v for k, v in serving_launches(4, range(4), range(4)).items()}
    rec, launches = {"card": card}, {}
    EdgeStylePipeline.__call__ = recorded
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_infer_") as root:
            flags = write_artifact_dirs(root)
            for name, extra, want in (
                    ("infer", ["--out", os.path.join(root, "r.png")], GEN_LAUNCHES_PER_REQUEST),
                    ("infer_sweep", ["--guidance_sweep", "--steps", "4", "--result_path",
                                     os.path.join(root, "res"), "--image_result_name", "g.png"],
                     sweep_want)):
                outs.clear()
                torch.cuda.empty_cache()
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                arr = infer.main(["--random_init"] + flags + extra, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches[name] = dict(kernels.LAUNCHES)
                path = os.path.join(root, "r.png") if name == "infer" else os.path.join(
                    root, "res", "g.png")
                rec[name] = {"cli_s": wall, "shape": list(arr.shape), "generations": len(outs),
                             "launches": launches[name], "predicted_launches": want}
                print(f"{name} ({card}): the infer CLI {wall:.2f} s with the init; image "
                      f"{arr.shape}, {len(outs)} generations; launches {launches[name]}, "
                      f"predicted {want}", flush=True)
                for i, out in enumerate(outs):
                    check_images(out, 1, f"{name} generation {i}")
                if not np.array_equal(np.asarray(Image.open(path)), arr):
                    fail(f"{name}: the written PNG is not the returned image")
                if name == "infer":
                    tile = (outs[0][0].permute(1, 2, 0).numpy() * 255).astype(np.uint8)
                    if len(outs) != 1 or arr.shape != (512, 512, 3) or not np.array_equal(
                            arr, tile):
                        fail("infer: the image is not the one generation's")
                else:
                    _, sources = infer.resolve_artifact_paths(infer.parse_args(flags))
                    row = (np.concatenate([infer._load(p, False)[0] for p in sources], axis=1)
                           * 255).astype(np.uint8)
                    if len(outs) != 6 or arr.shape != (1536, 1536, 3) or not np.array_equal(
                            arr[:512], row):
                        fail("infer_sweep: the grid is not the three sources and six "
                             "generations")
                if launches[name] != want:
                    fail(f"{name}: the kernel launches differ from the counts the code predicts")
    finally:
        EdgeStylePipeline.__call__ = call
    print(json.dumps({"infer": rec}), flush=True)
    return launches


def _live_trainables(state, gen):
    """A copy of the trainables with the zero-init ControlNet heads and LoRA
    ups given small random values, so that every trunk gradient is live."""
    from edgestyle_tpu_torch.core.params import flatten, unflatten

    out = {}
    for k, v in flatten(state["trainable"]).items():
        if (k[0].startswith("heads") and k[-1] == "kernel") or k[-1] == "up":
            fan_in = math.prod(v.shape[1:])
            v = torch.randn(v.shape, generator=gen, device=v.device) * (0.3 / math.sqrt(fan_in))
        out[k] = v.clone()
    return unflatten(out)


def _grad_diffs(g, g_p, groups):
    """Relative L2 difference of g from g_p per trainable group, and the
    worst single leaf's (key, relative L2 difference, |g_p leaf|_2)."""
    rel = lambda diff, norm: diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)  # noqa: E731
    per_group, worst = {}, (None, 0.0, 0.0)
    for group in groups:
        diff2 = norm2 = 0.0
        for k in (k for k in g_p if k[0] == group):
            d2 = (g[k].float() - g_p[k].float()).square().sum().item()
            n2 = g_p[k].float().square().sum().item()
            diff2, norm2 = diff2 + d2, norm2 + n2
            if rel(math.sqrt(d2), math.sqrt(n2)) > worst[1]:
                worst = (k, rel(math.sqrt(d2), math.sqrt(n2)), math.sqrt(n2))
        per_group[group] = (rel(math.sqrt(diff2), math.sqrt(norm2)), math.sqrt(norm2))
    return per_group, worst


def grad_check_phase(dev, built):
    """One micro-batch (B=1) through the kernels, then through the ops'
    plain versions (swapped in here, as e2e_phase swaps them), same weights
    and draws: the loss and each trainable group's gradients. Then once more
    through the kernels for each planted fault (dq set to 0, dv set to 0),
    which the check must reject."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core.params import flatten, unflatten
    from edgestyle_tpu_torch.models import layers
    from edgestyle_tpu_torch.ops import attention, flash, fused_conv
    from edgestyle_tpu_torch.training import train_step
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    pipe, frozen, tcfg, state = built
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    trainable = _live_trainables(state, gen)
    args = train.parse_args(TRAIN_ARGV + ["--train_batch_size", "1"])
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.synthetic_loader(args)).items()}
    draws = train_step.sample_draws(pipe, tcfg, batch, gen)[0]
    mb = {k: v[0] for k, v in batch.items()}
    sched = train_step.SCHEDULE.to(dev)

    def loss_and_grads():
        leaves = {k: v.detach().requires_grad_(True) for k, v in flatten(trainable).items()}
        loss = train_step.controlnet_loss_fn(unflatten(leaves), frozen, pipe, sched, tcfg, mb,
                                             draws)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    kernels.reset_launches()
    loss_k, g_k = loss_and_grads()
    launched = dict(kernels.LAUNCHES)
    if not all(launched.values()):
        fail(f"the kernel run of the gradient check missed a kernel: {launched}")
    saved = (layers.norm_act_conv3x3, attention.flash_attention)
    layers.norm_act_conv3x3 = fused_conv.norm_act_conv3x3_reference
    attention.flash_attention = flash.flash_attention_reference
    try:
        kernels.reset_launches()
        loss_p, g_p = loss_and_grads()
        torch.cuda.synchronize()
        if any(kernels.LAUNCHES.values()):
            fail("the plain run of the gradient check launched a kernel")
    finally:
        layers.norm_act_conv3x3, attention.flash_attention = saved
    # planted faults: a backward kernel's wrapper with one gradient zeroed
    dq_kernel, dkv_kernel = flash.flash_bwd_dq_cuda, flash.flash_bwd_dkv_cuda

    def dv_zero(*a):
        dk, dv = dkv_kernel(*a)
        return dk, dv.zero_()

    faults = {"planted fault dq = 0": ("flash_bwd_dq_cuda", lambda *a: dq_kernel(*a).zero_()),
              "planted fault dv = 0": ("flash_bwd_dkv_cuda", dv_zero)}
    g_faults = {}
    for what, (name, faulty) in faults.items():
        saved = getattr(flash, name)
        setattr(flash, name, faulty)
        try:
            g_faults[what] = loss_and_grads()[1]
        finally:
            setattr(flash, name, saved)
    kernels.reset_launches()
    print(f"gradient check (B=1, one micro-batch, bf16): loss through the kernels "
          f"{loss_k:.6f}, through the plain versions {loss_p:.6f}; kernel launches {launched}",
          flush=True)
    ok = {}
    for what, g in (("kernels", g_k), *g_faults.items()):
        per_group, (key, leaf_rel, leaf_norm) = _grad_diffs(g, g_p, TRAINABLE_GROUPS)
        print(f"  {what} vs plain: relative L2 difference per group (tol {GRAD_TOL}) "
              + ", ".join(f"{grp} {r:.3e} (|g_plain|_2 {n:.3e})"
                          for grp, (r, n) in per_group.items())
              + f"; worst leaf {'/'.join(map(str, key)) if key else '-'} {leaf_rel:.3e} "
              f"(tol {LEAF_TOL}; |g_plain|_2 {leaf_norm:.3e})", flush=True)
        ok[what] = all(r <= GRAD_TOL for r, _ in per_group.values()) and leaf_rel <= LEAF_TOL
    if not ok["kernels"]:
        fail("trainable gradients through the kernels and the plain versions disagree")
    for what in g_faults:
        if ok[what]:
            fail(f"the gradient check passed a {what}")


def profile_train_step(dev, built, out_dir: str) -> None:
    """One training step (micro-batch 2) under torch.profiler: device time
    by kernel family; the table goes to ``out_dir/profile_train.txt``."""
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.training import train_step

    pipe, frozen, tcfg, state = built
    args = train.parse_args(TRAIN_ARGV)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(train.synthetic_loader(args)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    step = train_step.make_train_step(pipe, tcfg)
    step(state, frozen, batch, train_step.sample_draws(pipe, tcfg, batch, gen))  # warm-up
    draws = train_step.sample_draws(pipe, tcfg, batch, gen)
    rows, wall, busy = profiled(lambda: step(state, frozen, batch, draws), out_dir,
                                "profile_train.txt")
    print(f"profile (one training step, micro-batch 2, profiler on): wall {wall:.3f} s, device "
          f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), {sum(r[1] for r in rows)} device "
          f"launches", flush=True)
    _print_families(rows, busy)


def profiled(fn, out_dir: str, file_name: str):
    """One call of fn under torch.profiler -> (device rows (ms, launches,
    kernel), wall s, device busy s); the table goes to out_dir/file_name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, file_name), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for ms, n, key in rows:
            f.write(f"{ms:12.3f} ms {n:7d}x  {key}\n")
    return rows, wall, busy


def _families(rows) -> dict:
    """{kernel family: (device ms, launches)}."""
    families = {}
    for ms, n, key in rows:
        t, c = families.get(_family(key), (0.0, 0))
        families[_family(key)] = (t + ms, c + n)
    return families


def _print_families(rows, busy: float) -> None:
    """Device time and launches by kernel family."""
    for fam, (ms, n) in sorted(_families(rows).items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam}: {ms:.3f} ms {100 * ms / 1e3 / busy:5.1f}% {n}x", flush=True)


def _device_rows(prof):
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return rows


def _family(key: str) -> str:
    """A device kernel's family, by its name."""
    for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_fwd_kernel"):
        if name in key:
            return name
    if ("fused_gn_silu_conv3x3" in key or "split_sum_kernel" in key
            or "gn_stats_kernel" in key):
        return "fused conv (gn_stats.cu + fused_conv.cu)"
    low = key.lower()
    if "conv" in low or "cudnn" in low or "dgrad" in low or "wgrad" in low:
        return "cuDNN convolutions (conv backward, 1x1 and strided convs)"
    if "gemm" in low or "cutlass" in low or "xmma" in low or "cublas" in low:
        return "cuBLAS / CUTLASS GEMMs"
    return "PyTorch elementwise, reductions and copies"


# ------------------------------------- segmenter, automatic masks, extraction
SEG_PHOTOS = 9  # the 99/1 split keeps 8: two batches of 4 an epoch
SEG_ARGV = ["--random_init", "--head", "clothes", "--epochs", "2", "--batch_size", "4",
            "--max_steps", "4"]
SEG_HEADS = ("subject", "head", "clothes", "body")
SEG_TIMED = 3
# One segmenter step, card (TF32 off) against the CPU, same weights, batch
# and box noise: the loss within SEG_LOSS_TOL relative, each decoder
# gradient leaf within SEG_GRAD_TOL relative L2. Both are fp32 through the
# ~100 layers of the SAM-L2 encoder, whose embedding the tryon_system phase
# reads 5.3e-6 apart. The key-projection biases' exact gradient is 0 (a
# softmax over the keys ignores a constant added to a row), and the IoU head
# and the three unused mask tokens' hypernetworks get none: those leaves
# are held to the whole decoder gradient's norm. A leaf scaled by
# SEG_FAULT (10% off) must be rejected.
SEG_LOSS_TOL = 1e-4
SEG_GRAD_TOL = 1e-3
SEG_FAULT = 1.1
# automatic_mask_candidates at its defaults (16 x 16 points, chunks of 64),
# card against the CPU: predicted IoU and stability within AUTO_SCORE_TOL
# (stability moves by 1 / the loose mask's area for each pixel whose logit
# crosses +-1), at most AUTO_MASK_SHARE_TOL of the mask pixels differ.
AUTO_SCORE_TOL = 1e-3
AUTO_MASK_SHARE_TOL = 1e-3
AUTO_TIMED = 3
EXTRACT_FRAMES = 6  # at 1280 x 720; frame 2 blank
EXTRACT_TOP_K = 2


def phase_out_dir(name: str) -> str:
    """A phase's files inside the checkout (git-ignored), emptied first."""
    d = os.path.join(HERE, "build", "torch_ext", f"chip_smoke_{name}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def write_parsing_folder(root: str, n: int, seed: int) -> None:
    """n non-square photos (images/*.jpg, 600 x 450) and their parsing
    labels (masks/*.png, uint8) with blocks of every label that one of the
    four heads keeps: hair 2, face 11, upper clothes 4, pants 6, legs 12/13,
    arms 14/15, shoes 9/10, placed per photo from ``seed``."""
    import numpy as np
    from PIL import Image

    g = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "masks"))
    h, w = 600, 450
    for i, photo in enumerate(make_photos(seed, n, w)):
        img = np.concatenate([photo, photo[: h - w]], axis=0)
        lab = np.zeros((h, w), np.uint8)
        cx, top = int(g.integers(180, 270)), int(g.integers(30, 70))
        for label, (y0, y1, x0, x1) in {
                2: (top, top + 40, cx - 45, cx + 45), 11: (top + 40, top + 100, cx - 35, cx + 35),
                4: (top + 100, top + 260, cx - 80, cx + 80),
                14: (top + 110, top + 280, cx - 120, cx - 80),
                15: (top + 110, top + 280, cx + 80, cx + 120),
                6: (top + 260, top + 420, cx - 70, cx + 70),
                12: (top + 420, top + 480, cx - 60, cx - 5),
                13: (top + 420, top + 480, cx + 5, cx + 60),
                9: (top + 480, top + 510, cx - 65, cx - 5),
                10: (top + 480, top + 510, cx + 5, cx + 65)}.items():
            lab[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = label
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"p{i}.jpg"), quality=95)
        Image.fromarray(lab).save(os.path.join(root, "masks", f"p{i}.png"))


def _seg_grad_errs(got: dict, want: dict) -> dict:
    """{leaf: |got - want|_2 / |want|_2} over flat gradient trees; a leaf
    whose exact gradient is 0 (a key-projection bias, or no gradient at
    all) is scaled by the whole tree's norm instead."""
    total = math.sqrt(sum(float(v.double().square().sum()) for v in want.values()))
    errs = {}
    for k, w in want.items():
        d = float((got[k].double().cpu() - w.double().cpu()).norm())
        n = float(w.double().norm())
        errs[".".join(k)] = d / (total if k[-2:] == ("k_proj", "bias") or n == 0 else n)
    return errs


def segmenter_phase(dev, card: str):
    """The segmenter finetuner at full width (module docstring, phase 16).
    Returns the kernels' launches of the entry point's run."""
    import numpy as np

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import extract_dataset, train_segmenter, tryon
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.core.safetensors import save_file
    from edgestyle_tpu_torch.models.efficientvit.sam import (
        SAM_L2,
        EfficientViTSam,
        _sam_rules,
        preprocess_sam_image,
    )
    from edgestyle_tpu_torch.models.openpose import BodyPoseNet, _bodypose_rules
    from edgestyle_tpu_torch.training import segmenter as seg

    rec = {"card": card}
    root = phase_out_dir("segmenter")
    data, out = os.path.join(root, "parsing"), os.path.join(root, "out")
    write_parsing_folder(data, SEG_PHOTOS, 15)

    # 1. the entry point: --random_init, head clothes, 2 epochs of 2 steps;
    # the peak is read above what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, frozen), text = _captured(lambda: train_segmenter.main(
        SEG_ARGV + ["--dataset_dir", data, "--output_dir", out], device=dev))
    torch.cuda.synchronize()
    rec["main_s"] = time.perf_counter() - t0
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["peak_memory_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    rec["losses"] = [ln["train_loss"] for ln in lines if "train_loss" in ln]
    bad = []
    if not (len(lines) == 4 and lines[0] == {"train": SEG_PHOTOS - 1, "val": 1, "head": "clothes"}
            and lines[-1].get("done") is True and lines[-1]["steps"] == 4):
        bad.append(f"JSON lines {lines}")
    if len(rec["losses"]) != 2 or not all(math.isfinite(v) for v in rec["losses"]):
        bad.append(f"epoch losses {rec['losses']}")
    fresh = EfficientViTSam(SAM_L2).init_params(make_generator(0, dev))
    for part in ("image_encoder", "prompt_encoder"):
        if not _trees_equal(frozen[part], fresh[part]):
            bad.append(f"the {part} moved")
    init = flatten(fresh["mask_decoder"])
    still = {k[0] for k, v in flatten(state["decoder"]).items() if torch.equal(v, init[k])}
    rec["decoder_groups_unmoved"] = sorted(still)
    if still != {"iou_mlp", "hyper_mlps_1", "hyper_mlps_2", "hyper_mlps_3"}:
        bad.append(f"decoder groups left where they were: {sorted(still)} (only the IoU head "
                   f"and the unused tokens' hypernetworks get no gradient)")

    # 2. the exported decoder through the try-on's --sam_clothes
    sam_file = os.path.join(root, "sam_l2.safetensors")
    pose_file = os.path.join(root, "pose.safetensors")
    save_file(upstream_state_dict(frozen, _sam_rules(SAM_L2), _sam_rename), sam_file)
    save_file(upstream_state_dict(BodyPoseNet().init_params(make_generator(1, dev)),
                                  _bodypose_rules(), _pose_rename), pose_file)
    trained_file = os.path.join(out, "trained_decoder_clothes.safetensors")
    args = extract_dataset.parse_args(["--input", data, "--output_dir", root, "--sam_checkpoint",
                                       sam_file, "--bodypose_checkpoint", pose_file,
                                       "--sam_clothes", trained_file])
    system = tryon.TryOnSystem(random_init=False, args=args, device=dev)
    if not _trees_equal(system.sam_params["decoders"]["clothes"], state["decoder"]):
        bad.append("the exported decoder does not load through --sam_clothes bit for bit")
    if not _trees_equal(system.sam_params["sam"], frozen):
        bad.append("the base SAM does not read back bit for bit")
    photo = make_photos(5, 1, 512)[0]
    ex = system.extract(photo, person_keypoints() * (512 / 46))
    if not all(ex[k].shape == (512, 512, 3) and np.isfinite(ex[k]).all()
               and 0 <= ex[k].min() and ex[k].max() <= 1
               for k in ("subject", "agnostic", "head", "clothes")):
        bad.append("TryOnSystem.extract with the trained head gave no finite [0, 1] composites")
    rec["extract_subject_score"] = float(ex["subject_score"])
    del system

    # 3. the library step: steady s/step and device launches at micro-batch 4
    images01, labels = train_segmenter.load_parsing_folder(data, SAM_L2.image_size)

    def batch_of(sel, d):
        return {"image": preprocess_sam_image(torch.from_numpy(images01[sel]).permute(0, 3, 1, 2)
                                              .to(d)),
                "labels": torch.from_numpy(labels[sel]).to(d)}

    sam = EfficientViTSam(SAM_L2)
    tcfg = seg.SegmenterTrainConfig(head="clothes")
    step = seg.make_segmenter_train_step(sam, tcfg)
    st = seg.init_segmenter_state(frozen, tcfg)
    gen = make_generator(3, dev)
    b4 = batch_of(slice(1, 5), dev)
    st, m = step(st, frozen, b4, seg.draw_box_noise(gen, 4, tcfg.box_jitter))  # warm-up
    times = []
    for _ in range(SEG_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, frozen, b4, seg.draw_box_noise(gen, 4, tcfg.box_jitter))
        float(m["loss"])
        times.append(time.perf_counter() - t0)
    rec["steady_s_per_step"] = statistics.median(times)
    rows, rec["step_profiled_wall_s"], busy = profiled(
        lambda: step(st, frozen, b4, seg.draw_box_noise(gen, 4, tcfg.box_jitter)), root,
        "profile_segmenter_step.txt")
    rec["step_device_launches"] = sum(r[1] for r in rows)
    rec["step_device_ms"] = busy * 1e3
    del st, b4

    # 4. one step of each head, card against CPU; a planted fault
    cpu = torch.device("cpu")
    frozen_cpu = _to(frozen, cpu)
    noise = torch.tensor([[3, -7, 12, -2], [-15, 4, 0, 9]])
    rec["card_vs_cpu"] = {}
    fault_errs = None
    for head in SEG_HEADS:
        cfg = seg.SegmenterTrainConfig(head=head)
        lc, gc = seg.segmenter_grads(sam, cfg, frozen["mask_decoder"], frozen,
                                     batch_of(slice(1, 3), dev), noise.to(dev))
        lp, gp = seg.segmenter_grads(sam, cfg, frozen_cpu["mask_decoder"], frozen_cpu,
                                     batch_of(slice(1, 3), cpu), noise)
        gc, gp = flatten(gc), flatten(gp)
        errs = _seg_grad_errs(gc, gp)
        rec["card_vs_cpu"][head] = {"loss": float(lp), "loss_rel_err":
                                    abs(float(lc) - float(lp)) / abs(float(lp)),
                                    "grad_max_rel_l2": max(errs.values())}
        if head == "clothes":
            planted = dict(gc)
            key = ("hyper_mlps_0", "layers_2", "kernel")
            planted[key] = planted[key] * SEG_FAULT
            fault_errs = _seg_grad_errs(planted, gp)
    rec["planted_fault_max_rel_l2"] = max(fault_errs.values())
    torch.cuda.empty_cache()

    worst = max(v["grad_max_rel_l2"] for v in rec["card_vs_cpu"].values())
    worst_loss = max(v["loss_rel_err"] for v in rec["card_vs_cpu"].values())
    print(f"segmenter ({card}): train_segmenter.main --random_init --head clothes at SAM-L2 "
          f"{SAM_L2.image_size} px fp32, micro-batch 4, 4 steps in {rec['main_s']:.2f} s "
          f"(epoch losses {rec['losses']}), peak device memory {rec['peak_memory_gib']:.2f} GiB "
          f"above the phase's start, "
          f"kernel launches {rec['launches']}; steady {rec['steady_s_per_step']:.4f} s/step "
          f"(median of {SEG_TIMED}), one step {rec['step_device_launches']} device launches, "
          f"{rec['step_device_ms']:.3f} ms device time in {rec['step_profiled_wall_s']:.3f} s "
          f"(profiler on); card vs CPU over the four heads: loss {worst_loss:.2e} relative (tol "
          f"{SEG_LOSS_TOL}), worst leaf {worst:.2e} relative L2 (tol {SEG_GRAD_TOL}); planted "
          f"fault x{SEG_FAULT}: {rec['planted_fault_max_rel_l2']:.2e}; unmoved decoder groups "
          f"{rec['decoder_groups_unmoved']}", flush=True)
    print(f"  one step by kernel family:", flush=True)
    _print_families(rows, busy)
    print(json.dumps({"segmenter": rec}), flush=True)
    if any(rec["launches"].values()):
        bad.append(f"the segmenter launched hand-written kernels {rec['launches']}; its path "
                   f"has none")
    if worst_loss > SEG_LOSS_TOL or worst > SEG_GRAD_TOL:
        bad.append("the step on the card disagrees with the CPU")
    if not rec["planted_fault_max_rel_l2"] > SEG_GRAD_TOL:
        bad.append("the card-vs-CPU gradient check did not reject a leaf scaled by 1.1")
    if bad:
        fail("segmenter: " + "; ".join(bad))
    return rec["launches"]


def auto_mask_phase(dev, card: str):
    """SAM's automatic mask candidates at full width (module docstring,
    phase 17). Returns the kernels' launches of the card run."""
    import numpy as np

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.models.efficientvit.sam import (
        SAM_L2,
        EfficientViTSam,
        automatic_mask_candidates,
        preprocess_sam_image,
        select_auto_masks,
    )

    rec = {"card": card}
    sam = EfficientViTSam(SAM_L2)
    params = sam.init_params(make_generator(21, dev))
    photo = torch.from_numpy(make_photos(9, 1, SAM_L2.image_size)[0]).permute(2, 0, 1)[None]
    img = preprocess_sam_image(photo.to(dev))
    kernels.reset_launches()
    run = lambda: automatic_mask_candidates(sam, params, img)  # noqa: E731
    run()
    times = []
    for _ in range(AUTO_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_out = [t.cpu() for t in run()]
        times.append(time.perf_counter() - t0)
    rec["ms_per_image"] = 1e3 * statistics.median(times)
    rec["launches"] = dict(kernels.LAUNCHES)
    rows, rec["profiled_wall_s"], busy = profiled(run, phase_out_dir("auto_mask"),
                                                  "profile_auto_mask.txt")
    rec["device_launches"] = sum(r[1] for r in rows)
    rec["device_ms"] = busy * 1e3
    t0 = time.perf_counter()
    cpu_out = automatic_mask_candidates(sam, _to(params, torch.device("cpu")), img.cpu())
    rec["cpu_s"] = time.perf_counter() - t0
    (m, iou, stab), (mc, iouc, stabc) = card_out, cpu_out
    rec["candidates"] = int(m.shape[0])
    rec["iou_max_abs_err"] = float((iou - iouc).abs().max())
    rec["stability_max_abs_err"] = float((stab - stabc).abs().max())
    rec["mask_pixel_diff_share"] = float((m != mc).float().mean())
    rec["mask_share"] = float(mc.float().mean())
    t0 = time.perf_counter()
    kept = {}
    for name, (thr_i, thr_s) in {"defaults": (0.88, 0.95),
                                 "medians": (float(iouc.median()), float(stabc.median()))}.items():
        a = select_auto_masks(m, iou, stab, pred_iou_thresh=thr_i, stability_thresh=thr_s)
        b = select_auto_masks(mc, iouc, stabc, pred_iou_thresh=thr_i, stability_thresh=thr_s)
        kept[name] = {"card": len(a), "cpu": len(b)}
    rec["select_s"] = (time.perf_counter() - t0) / 4
    rec["kept"] = kept
    print(f"auto_mask ({card}): automatic_mask_candidates at SAM-L2 {SAM_L2.image_size} px "
          f"(16 x 16 points, chunks of 64, {rec['candidates']} candidates) "
          f"{rec['ms_per_image']:.2f} ms per image with the masks to the host (median of "
          f"{AUTO_TIMED}), {rec['device_launches']} device launches, {rec['device_ms']:.3f} ms "
          f"device time in {rec['profiled_wall_s']:.3f} s (profiler on), kernel launches "
          f"{rec['launches']}; CPU {rec['cpu_s']:.2f} s; card vs CPU: iou "
          f"{rec['iou_max_abs_err']:.2e}, "
          f"stability {rec['stability_max_abs_err']:.2e} (tol {AUTO_SCORE_TOL}), mask pixels "
          f"differing {rec['mask_pixel_diff_share']:.2e} (tol {AUTO_MASK_SHARE_TOL}); "
          f"select_auto_masks {rec['select_s']:.3f} s, kept {kept}", flush=True)
    _print_families(rows, busy)
    print(json.dumps({"auto_mask": rec}), flush=True)
    bad = []
    if any(rec["launches"].values()):
        bad.append(f"hand-written kernels launched {rec['launches']}; the path has none")
    if rec["iou_max_abs_err"] > AUTO_SCORE_TOL or rec["stability_max_abs_err"] > AUTO_SCORE_TOL:
        bad.append("predicted IoU or stability disagree with the CPU")
    if rec["mask_pixel_diff_share"] > AUTO_MASK_SHARE_TOL:
        bad.append("the masks disagree with the CPU's")
    if not (m.dtype == torch.bool and m.shape == (768, 256, 256) and np.isfinite(
            iou.numpy()).all() and ((stab >= 0) & (stab <= 1)).all()):
        bad.append("the candidates' types, shapes or ranges are wrong")
    if bad:
        fail("auto_mask: " + "; ".join(bad))
    return rec["launches"]


def write_frames(root: str, n: int, seed: int, blank: int = 2) -> None:
    """n 1280 x 720 PNG frames (make_photos' field and subject blob, side by
    side with a second field); frame ``blank`` is one flat gray."""
    import numpy as np
    from PIL import Image

    os.makedirs(root)
    photos = make_photos(seed, 2 * n, 720)
    for i in range(n):
        frame = np.concatenate([photos[2 * i], photos[2 * i + 1][:, : 1280 - 720]], axis=1)
        if i == blank:
            frame = np.full_like(frame, 0.5)
        Image.fromarray((frame * 255).astype(np.uint8)).save(os.path.join(root, f"{i:03d}.png"))


def extract_phase(dev, card: str, clip_files: dict):
    """The dataset extractor at full width (module docstring, phase 18).
    Returns the kernels' launches of the CLI and the posed run together."""
    import numpy as np

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import extract_dataset, tryon
    from edgestyle_tpu_torch.data import curation

    rec = {"card": card}
    root = phase_out_dir("extract")
    frames_dir = os.path.join(root, "frames")
    write_frames(frames_dir, EXTRACT_FRAMES, 31)
    clip = ["--tokenizer_dir", clip_files["tok_dir"], "--clip_model", clip_files["clip_dir"]]
    built = []
    system_cls = tryon.TryOnSystem

    def capture(*a, **kw):  # keep main's system for the posed run
        built.append(system_cls(*a, **kw))
        return built[-1]

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tryon.TryOnSystem = capture
    try:
        line, _ = _captured(lambda: extract_dataset.main(
            ["--random_init", "--input", frames_dir, "--output_dir",
             os.path.join(root, "cli", "subject0"), "--every_n", "1", "--top_k",
             str(EXTRACT_TOP_K), "--score_threshold", "0", *clip], device=dev))
    finally:
        tryon.TryOnSystem = system_cls
    torch.cuda.synchronize()
    rec["cli_s"] = time.perf_counter() - t0
    rec["cli_stats"] = line
    bad = []
    boxed = line["box_from_pose"] + line["box_fallback"]
    kept = boxed - line["dropped_no_pose_on_crop"] - line["dropped_low_score"]
    if not (line["frames_in"] == EXTRACT_FRAMES and boxed + line["dropped_no_box"]
            == EXTRACT_FRAMES and line["frames_written"] == min(kept, EXTRACT_TOP_K)):
        bad.append(f"the CLI's stats do not account for every frame: {line}")

    # the same system, its pose replaced by a known person (random weights
    # find none): every frame is posed, so frames reach SAM, IQA and disk.
    # Random weights predict a subject IoU of no meaning (-0.018 on the
    # card), so this run opens the score gate; the CPU tests hold the gate
    system = built[0]
    times = {"pose": 0.0, "sam": 0.0, "iqa": 0.0}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t0
            return out
        return call

    kp = person_keypoints() * (512 / 46)
    pose = timed("pose", system.detect_pose)
    system.detect_pose = lambda img01: (kp.copy(), pose(img01)[1])
    system.extract = timed("sam", system.extract)
    tok, enc_img, enc_txt = curation._clip_encoders(clip_files["tok_dir"],
                                                    clip_files["clip_dir"], dev)
    iqa = timed("iqa", curation.ClipIQA(tok, enc_img, enc_txt, curation.EXTRACTION_PROMPT_PAIRS))
    frames = extract_dataset.load_frames(frames_dir)
    stats = {}
    posed = os.path.join(root, "posed")
    t0 = time.perf_counter()
    n = extract_dataset.extract_subject(system, frames, os.path.join(posed, "subject0"),
                                        top_k=EXTRACT_TOP_K, iqa=iqa,
                                        score_threshold=-math.inf, stats=stats)
    rec["posed_s"] = time.perf_counter() - t0
    rec["posed_stats"] = dict(stats, frames_written=n)
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["s_per_frame"] = {"cli": rec["cli_s"] / EXTRACT_FRAMES,
                          "posed": rec["posed_s"] / EXTRACT_FRAMES,
                          **{k: v / EXTRACT_FRAMES for k, v in times.items()}}
    if n != EXTRACT_TOP_K or stats["box_from_pose"] != EXTRACT_FRAMES:
        bad.append(f"the posed run wrote {n} frames, stats {stats}")
    for art in ("processed", "openpose", "openpose_json", "subject", "mask", "agnostic", "head",
                "clothes"):
        if len(os.listdir(os.path.join(posed, "subject0", art))) != n:
            bad.append(f"{art}/ does not hold {n} files")
    missing = curation.find_missing_artifacts(posed)
    if missing:
        bad.append(f"find_missing_artifacts found {missing}")
    del system, built, iqa
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, out = _captured(lambda: curation.main(["bad", posed, *clip, "--worst_k", "3"], device=dev))
    rec["curation_bad_s"] = time.perf_counter() - t0
    scores = [float(ln.split()[0]) for ln in out.splitlines() if ln.strip()]
    if len(scores) != 3 or not all(0 <= v <= 1 for v in scores) or scores != sorted(scores):
        bad.append(f"curation bad printed {out!r}")
    rec["curation_bad_scores"] = scores
    if any(rec["launches"].values()):
        bad.append(f"hand-written kernels launched {rec['launches']}; the path has none")
    sp = rec["s_per_frame"]
    print(f"extract ({card}): extract_dataset.main --random_init on {EXTRACT_FRAMES} frames of "
          f"1280 x 720 with CLIP-IQA at ViT-L/14: {rec['cli_s']:.2f} s with the system's and "
          f"the IQA's init, stats {line}; posed extract_subject {rec['posed_s']:.2f} s "
          f"({sp['posed']:.3f} s a frame, of which pose net {sp['pose']:.3f}, SAM and the mask "
          f"algebra {sp['sam']:.3f}, CLIP-IQA {sp['iqa']:.3f}), stats {stats}, {n} frames "
          f"written; curation bad at full width {rec['curation_bad_s']:.2f} s, worst scores "
          f"{scores}; kernel launches {rec['launches']}", flush=True)
    print(json.dumps({"extract": rec}), flush=True)
    if bad:
        fail("extract: " + "; ".join(bad))
    return rec["launches"]


# ------------------------------------------------------------- multicard
# Several cards on the one card of this machine. (a) an NCCL group of one
# rank on cuda:0: generate_dp and a data-parallel train step, each against
# the single-process call on the same inputs, bit for bit (one rank runs
# the same call on every row; the all-reduce of one rank returns its
# input). (b) two ranks that both name cuda:0 and gloo (NCCL refuses two
# ranks on one device): generate_dp at B=2 (one row a rank) against (a)'s
# single-process images, generate_tp at model=2, B=1, against the
# single-process B=1 image (exact, int8 and int8-static), and one
# data-parallel train step at a global micro-batch of 2 against (a)'s
# single-process step. (c) four ranks on cuda:0 over gloo, the (data 2,
# model 2) mesh: the DP x TP train step against (a)'s single-process step,
# and its sharded resume.
MC_STEPS = 4
MC_LATENT_SEED, MC_REQUEST_SEED, MC_DRAW_SEED = 5, 17, 9
# The DP train step against the single-process step, --adam_epsilon 1
# (tests/test_torch_multicard.py's conditioning: Prodigy's first step is
# ~d sign(g) at eps 1e-8, so an element whose gradient is near roundoff
# takes either sign on either side; above every |g| the update follows g),
# the loss and d relative, each group's gradient (Prodigy's first exp_avg,
# (1 - beta1) d g) and update (after - before) as relative L2, in three
# runs:
#   "bf16": the trainer's own step from its initial state (zero-init heads,
#     so the adapters get no gradient yet): the loss and d within
#     MC_LOSS_TOL, gradients and updates within GRAD_TOL (the ranks' B=1
#     rows run other cuBLAS / cuDNN algorithms than the single process's
#     B=2, as the kernels' and the plain versions' roundings differ there);
#   "bf16_live": live trainables (grad_check_phase's _live_trainables),
#     every adapter's gradient live: gradients within GRAD_TOL; the updates
#     are read, not held: Prodigy's first step at d = 1e-6 moves a nonzero
#     weight by less than its ulp, so after - before is mostly rounding;
#   "fp32": --mixed_precision no, live: B=1 and B=2 round alike to ~1e-6,
#     so the gradients are held at MC_FP32_TOL (the loss and d too).
MC_TRAIN_ARGV = ["--random_init", "--resolution", "512", "--train_batch_size", "2",
                 "--gradient_accumulation_steps", "1", "--seed", "0", "--adam_epsilon", "1"]
MC_TRAIN_RUNS = {"bf16": ("bf16", False), "bf16_live": ("bf16", True), "fp32": ("no", True)}
# (b) against the single-process path, uint8 levels of the [0, 1] images:
# the DP rows run at B=1 where the single process ran B=2 (other cuBLAS /
# cuDNN algorithms, other split counts of the fused conv: the bf16 sums
# round apart), and under TP each row-parallel Dense sums two bf16 partial
# products; both as the server's coalesced-vs-alone check (SERVE_MEAN_TOL,
# SERVE_MAX_TOL, over 20 steps there, MC_STEPS here).
MC_LOSS_TOL = 1e-2
MC_FP32_TOL = 1e-3
MC_INT8_MODES = ("int8", "int8-static")
# The int8-static table recorded under TP against the single process's, the
# largest relative difference of a key's scale. Equal bit for bit on the
# CPU (tests/test_torch_dptp.py); on the card the plain cross-attention's
# batched bf16 P.V at the lora_1 trunk's (4 rows, 256 x 77 x 160) takes
# another cuBLAS algorithm at 4 heads than at 8 and rounds up to 1.2e-4
# apart, and int8's rounding of the next layers carries that to 1.9e-2 in
# 52 of 583 keys (on an H100 80GB HBM3 at 700 W). A rank that records its own
# share's absmax in place of the whole tensor's (the planted fault) must
# leave this limit.
MC_INT8_TABLE_TOL = 0.05
# int8 generate_tp's image against the single process's, (mean, max) uint8
# levels. "int8": (b)'s limits (the scales are dynamic, taken over the whole
# tensors). "int8-static": each run records its own table, and the 52 keys
# above move the images by 5.0480 mean and 42 max levels after MC_STEPS
# steps, outside (b)'s limits; the planted fault (each rank's own absmax in
# its table) by 8.1129 / 70 and 9.2733 / 76 on the two ranks (each the same
# in every run on an H100 80GB HBM3 at 700 W). The limit lies between the
# two readings, about a quarter from each.
MC_INT8_LEVEL_TOL = {"int8": (SERVE_MEAN_TOL, SERVE_MAX_TOL), "int8-static": (6.5, 56)}
# (c) the DP x TP train step on four ranks: (data, model) of each run, one
# row a data rank, live trainables; held against (a)'s single-process step
# as (b)'s DP step is (gradients per group, the loss and d); on the bf16
# run a planted fault (the LoRA merge's model-group sum left out) must fail
# the gradient check, and the new state is saved and resumed. Four fp32
# ranks fit on the card (10.74 GiB a rank at peak), so fp32 runs on the
# same mesh.
MC_DPTP_RUNS = {"bf16_live": (2, 2), "fp32": (2, 2)}


def tp_all_reduces(pipe, params, steps: int) -> int:
    """The all-reduces of one generate_tp call, from the code: 3 a
    transformer block (to_out of attn1 and attn2, ff.proj_out) in every
    model evaluation (the UNet and one trunk call a branch group, one
    evaluation a UniPC step), and 1 a CLIP layer (fc2) in the one prompt
    encode; the VAE's single-head attention stays whole."""
    from edgestyle_tpu_torch.core.params import flatten

    def blocks(tree):
        return sum(1 for k in flatten(tree) if k[-3:] == ("attn1", "to_q", "kernel"))

    trunk = blocks(params["controlnet"]["static"])
    return (3 * steps * (blocks(params["unet"]) + len(pipe.mcn.groups) * trunk)
            + pipe.cfg.clip.num_layers)


def tp_int8_collectives(pipe, params, steps: int, static: bool) -> int:
    """The model group's collectives of one int8 generate_tp call, from the
    code: each transformer block's three row-parallel Denses (to_out of
    attn1 and attn2, ff.proj_out) sum their int32 accumulators, and on a
    dynamic activation scale first max its absmax: 2 each under "int8", in
    every model evaluation (the UNet and one trunk call a branch group);
    under "int8-static" 2 each in the 5 calibration evaluations (recorded
    scales are dynamic) and 1 in each step. The text tower runs whole."""
    from edgestyle_tpu_torch.core.params import flatten

    def blocks(tree):
        return sum(1 for k in flatten(tree) if k[-3:] == ("attn1", "to_q", "kernel"))

    per_eval = 3 * (blocks(params["unet"]) + len(pipe.mcn.groups)
                    * blocks(params["controlnet"]["static"]))
    return 2 * 5 * per_eval + steps * per_eval if static else 2 * steps * per_eval


def dptp_collectives(pipe, unet, trainable, rows: int, act_bytes: int, tp_size: int) -> dict:
    """The model group's collectives of one DP x TP micro-batch of ``rows``
    local rows, from the code. Forward (ReduceFromModel): each transformer
    block's three row-parallel outputs (rows, N, C) in the compute type, in
    the UNet and in each branch group's trunk call (rows times its
    branches), and each CLIP layer's fc2 output (rows, 77, 768). Backward
    (CopyToModel): the gradients of those blocks' three column-parallel
    inputs where they carry one (the UNet's up blocks, the LoRA trunks;
    attn2's context is the frozen CLIP's and carries none), and of each
    LoRA adapter leaf (fp32) on a kernel the model axis splits."""
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.core.partitioning import tp_layout
    from edgestyle_tpu_torch.models.unet import split_trunk_params

    cfg = pipe.cfg
    side = cfg.vae.sample_size // pipe.vae_downscale
    levels = len(cfg.unet.block_out_channels)

    def tokens(top):
        i = int(top.rsplit("_", 1)[1]) if top.startswith(("down", "up")) else levels - 1
        return (side >> (levels - 1 - i if top.startswith("up") else i)) ** 2

    blocks = [(k[0], v.shape[0]) for k, v in flatten(unet).items()
              if k[-3:] == ("attn1", "to_out", "kernel")]
    trunk = [b for b in blocks if not b[0].startswith("up")]
    up = [b for b in blocks if b[0].startswith("up")]

    def act(bs, r):
        return sum(3 * r * tokens(top) * c * act_bytes for top, c in bs)

    lora = [g for g in pipe.mcn.groups if g.kind == "lora"]
    sliced = tp_layout(split_trunk_params(unet), tp_size, cfg.unet.num_heads)
    adapters = [(k, v) for k, v in flatten(trainable["lora_0"]).items()
                if k[:-1] in sliced and v.ndim == 2]
    clip = cfg.clip
    return {
        "forward": 3 * (len(blocks) + len(pipe.mcn.groups) * len(trunk)) + clip.num_layers,
        "forward_bytes": act(blocks, rows) + sum(act(trunk, rows * len(g.positions))
                                                 for g in pipe.mcn.groups)
        + clip.num_layers * rows * clip.max_positions * clip.hidden_size * act_bytes,
        "backward": 3 * (len(up) + len(lora) * len(trunk)) + len(lora) * len(adapters),
        "backward_bytes": act(up, rows) + sum(act(trunk, rows * len(g.positions)) for g in lora)
        + len(lora) * sum(4 * v.numel() for _, v in adapters),
    }


def _mc_request(pipe, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(MC_REQUEST_SEED)
    ids, neg, imgs, _ = make_request(gen, dev, 2, pipe.cfg.num_branches,
                                     pipe.cfg.latent_branches)
    return ids, neg, imgs


def _mc_train_step(dev, mesh, run: str, ckpt_root=None) -> dict:
    """One train step of MC_TRAIN_RUNS[run] from the trainer's full-width
    build: one global synthetic batch and its draws, this rank's rows of
    both with ``mesh`` (the DP step), all of both without. Returns the
    loss, d, the trainables before and after on the host, the seconds, the
    launches and the bytes all-reduced. On a mesh with a model axis above
    1 (the DP x TP step): the frozen set sharded
    (``shard_pipeline_frozen_tp``), the step's model-group collectives and
    their prediction (``dptp_collectives``) and the peak memory; and,
    given ``ckpt_root``, the step with the LoRA merge's model-group sum
    left out (the planted fault) and the new state saved there and resumed
    with ``load_checkpoint_sharded`` (held bit for bit)."""
    import types

    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.apps import train
    from edgestyle_tpu_torch.core import mesh as M
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.core.partitioning import shard_pipeline_frozen_tp
    from edgestyle_tpu_torch.models import unet as unet_module
    from edgestyle_tpu_torch.ops import tp
    from edgestyle_tpu_torch.training.checkpoint import (
        load_checkpoint_sharded,
        save_checkpoint,
        states_equal,
    )
    from edgestyle_tpu_torch.training.train_step import (
        make_optimizer,
        make_train_step,
        sample_draws,
    )

    precision, live = MC_TRAIN_RUNS[run]
    args = train.parse_args(MC_TRAIN_ARGV + ["--mixed_precision", precision])
    pipe, frozen, tcfg, state, _ = train.build(args, dev)
    if live:
        trainable = _live_trainables(state, make_generator(MC_DRAW_SEED + 1, dev))
        state = {"trainable": trainable, "opt_state": make_optimizer(tcfg).init(trainable),
                 "step": 0}
    host = next(train.synthetic_loader(args))
    batch, draws = train.rank_batch(
        mesh, host, sample_draws(pipe, tcfg, host, make_generator(MC_DRAW_SEED, dev)))
    dptp = mesh is not None and M.axis_size(mesh, M.MODEL_AXIS) > 1
    out = {}
    if dptp:
        cfg = pipe.cfg
        out["predicted"] = dptp_collectives(
            pipe, frozen["unet"], state["trainable"], batch["original"].shape[1],
            2 if precision == "bf16" else 4, M.axis_size(mesh, M.MODEL_AXIS))
        frozen = shard_pipeline_frozen_tp(mesh, frozen, {
            "vae": 1, "clip": cfg.clip.num_heads, "unet": cfg.unet.num_heads,
            "static": cfg.unet.num_heads})
    if dptp:
        step = make_train_step(pipe, tcfg, model_group=mesh.get_group(M.MODEL_AXIS))
    else:
        step = make_train_step(pipe, tcfg, data_group=None if mesh is None
                               else mesh.get_group(M.DATA_AXIS))
    kernels.reset_launches()
    M.ALL_REDUCE_BYTES[0] = 0
    tp.ALL_REDUCES[0] = tp.REDUCED_BYTES[0] = 0
    tp.BACKWARD_ALL_REDUCES[0] = tp.BACKWARD_BYTES[0] = 0
    torch.cuda.reset_peak_memory_stats()
    secs, (new, metrics) = _wall(lambda: step(state, frozen, batch, draws), 1)
    host_tree = lambda t: {k: v.cpu() for k, v in flatten(t).items()}  # noqa: E731
    out.update({"loss": metrics["loss"].item(), "d": metrics["d"].item(), "s": secs,
                "before": host_tree(state["trainable"]), "after": host_tree(new["trainable"]),
                "exp_avg": host_tree(new["opt_state"]["exp_avg"]),
                "launches": dict(kernels.LAUNCHES), "bytes": M.ALL_REDUCE_BYTES[0],
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if dptp:
        out["tp"] = {"forward": tp.ALL_REDUCES[0], "forward_bytes": tp.REDUCED_BYTES[0],
                     "backward": tp.BACKWARD_ALL_REDUCES[0],
                     "backward_bytes": tp.BACKWARD_BYTES[0]}
    if dptp and ckpt_root:
        unet_module.tp = types.SimpleNamespace(copy_to_model=lambda x: x, size=tp.size,
                                               index=tp.index)
        try:
            faulty, _ = step(state, frozen, batch, draws)
        finally:
            unet_module.tp = tp
        out["fault_exp_avg"] = host_tree(faulty["opt_state"]["exp_avg"])
        del faulty
        t0 = time.perf_counter()
        save_checkpoint(ckpt_root, new)
        resumed = load_checkpoint_sharded(ckpt_root, new, mesh)
        out["resume_s"] = time.perf_counter() - t0
        out["resumed_bit_equal"] = states_equal(resumed, new)
    return out


def _multicard_rank(steps: int) -> dict:
    """One of (b)'s two ranks: both on cuda:0 over gloo."""
    from edgestyle_tpu_torch import kernels
    from edgestyle_tpu_torch.core import mesh as M
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.ops import quant, tp
    from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

    # as main() sets them for this script's own process (cuDNN's default
    # would run the fp32 convs in TF32 here and not there)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = M.init_distributed(torch.device("cuda", 0), backend="gloo")
    dp_mesh = M.make_mesh(M.MeshSpec(data=2, model=1), dev)
    tp_mesh = M.make_mesh(M.MeshSpec(data=1, model=2), dev)
    pipe, params, _ = build_pipeline(dev)
    ids, neg, imgs = _mc_request(pipe, dev)
    replicate_s, _ = _wall(lambda: M.replicate_params(dp_mesh, params), 1)
    out = {"rank": torch.distributed.get_rank(), "replicate_s": replicate_s}

    kernels.reset_launches()
    out["dp_s"], dp = _wall(lambda: pipe.generate_dp(
        dp_mesh, params, ids, neg, imgs, generator=make_generator(MC_LATENT_SEED, dev),
        num_inference_steps=steps), 1)
    out["dp"], out["dp_launches"] = dp.cpu(), dict(kernels.LAUNCHES)

    kernels.reset_launches()
    tp.ALL_REDUCES[0] = tp.REDUCED_BYTES[0] = 0
    out["tp_s"], tpi = _wall(lambda: pipe.generate_tp(
        tp_mesh, params, ids[:1], neg[:1], [im[:1] for im in imgs],
        generator=make_generator(MC_LATENT_SEED, dev), num_inference_steps=steps), 1)
    out["tp"], out["tp_launches"] = tpi.cpu(), dict(kernels.LAUNCHES)
    out["all_reduces"], out["tp_bytes"] = tp.ALL_REDUCES[0], tp.REDUCED_BYTES[0]
    out["all_reduces_predicted"] = tp_all_reduces(pipe, params, steps)
    del dp, tpi
    out["int8_tp"] = {}
    request = (ids[:1], neg[:1], [im[:1] for im in imgs])

    def generate(mode, table=None, tp_on=None, n=steps):
        qpipe = EdgeStylePipeline(pipe.cfg, device=dev, quant=mode)
        qpipe._int8_scales = table
        quant.reset_counts()
        tp.ALL_REDUCES[0] = 0
        kw = dict(generator=make_generator(MC_LATENT_SEED, dev), num_inference_steps=n)
        secs, img = _wall(lambda: qpipe(params, *request, **kw) if tp_on is None
                          else qpipe.generate_tp(tp_on, params, *request, **kw), 1)
        return {"s": secs, "image": img.cpu(), "counts": dict(quant.COUNTS),
                "table": qpipe._int8_scales, "collectives": tp.ALL_REDUCES[0]}

    for mode in MC_INT8_MODES:
        # the single-process int8 generation in this process, then generate_tp
        single = generate(mode)
        rec = generate(mode, tp_on=tp_mesh)
        rec.update(single=single, collectives_predicted=tp_int8_collectives(
            pipe, params, steps, mode == "int8-static"))
        if mode == "int8-static":
            # the single process generating on the table recorded under TP
            # (read: what is left once the tables agree), and the planted
            # fault: generate_tp with each rank's own absmax of its share
            # recorded in its table (the model group's max left out)
            rec["single_on_tp_table"] = generate(mode, table=dict(rec["table"]))
            max_over_model = tp.max_over_model
            tp.max_over_model = lambda x: x
            try:
                rec["fault"] = generate(mode, tp_on=tp_mesh)
            finally:
                tp.max_over_model = max_over_model
        out["int8_tp"][mode] = rec
    del pipe, params
    torch.cuda.empty_cache()

    out["train"] = {}
    for run in MC_TRAIN_RUNS:
        out["train"][run] = _mc_train_step(dev, dp_mesh, run)
        torch.cuda.empty_cache()
    return out


def _dptp_rank(ckpt_root: str) -> dict:
    """One of (c)'s four ranks, all on cuda:0 over gloo: the DP x TP train
    step of each MC_DPTP_RUNS run on its (data, model) mesh."""
    from edgestyle_tpu_torch.core import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = M.init_distributed(torch.device("cuda", 0), backend="gloo")
    out = {"rank": torch.distributed.get_rank(), "train": {}}
    for run, spec in MC_DPTP_RUNS.items():
        mesh = M.make_mesh(M.MeshSpec(*spec), dev)
        # the planted fault and the sharded resume on the bf16 run
        rec = _mc_train_step(dev, mesh, run, ckpt_root if run.startswith("bf16") else None)
        rec["coords"] = (M.axis_index(mesh, M.DATA_AXIS), M.axis_index(mesh, M.MODEL_AXIS))
        out["train"][run] = rec
        torch.cuda.empty_cache()
    return out


def _mc_update_diffs(dp: dict, single: dict) -> dict:
    """The DP step against the single-process one: the loss's and d's
    relative differences, and per trainable group the relative L2
    difference of the updates (after - before) and of the gradients
    (Prodigy's first exp_avg, (1 - beta1) d g: an update below a weight's
    ulp is lost in the weight, not in exp_avg); 0 where both are 0."""
    from edgestyle_tpu_torch.training.train_step import TRAINABLE_GROUPS

    def rel_l2(a, b, base):
        num = math.sqrt(sum((a[k] - b[k]).float().square().sum().item() for k in a))
        den = math.sqrt(sum((b[k] - base[k]).float().square().sum().item() for k in a))
        return num / den if den > 0 else (0.0 if num == 0 else math.inf)

    groups, grads = {}, {}
    for g in TRAINABLE_GROUPS:
        keys = [k for k in single["before"] if k[0] == g]
        pick = lambda t: {k: t[k] for k in keys}  # noqa: E731
        groups[g] = rel_l2(pick(dp["after"]), pick(single["after"]), single["before"])
        zero = {k: torch.zeros_like(v) for k, v in pick(single["exp_avg"]).items()}
        grads[g] = rel_l2(pick(dp["exp_avg"]), pick(single["exp_avg"]), zero)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    return {"loss": rel(dp["loss"], single["loss"]), "d": rel(dp["d"], single["d"]),
            "groups": groups, "grads": grads}


def _table_rel(a: dict, b: dict):
    """The largest relative difference of two int8-static tables' scales,
    or "other keys"."""
    if a.keys() != b.keys():
        return "other keys"
    return max(abs(a[k] / b[k] - 1) for k in b)


def _level_diff(a, b):
    """(mean, max) |a - b| of two [0, 1] image batches in uint8 levels."""
    d = ((a.float() * 255).round() - (b.float() * 255).round()).abs()
    return d.mean().item(), d.max().item()


def multicard_phase(dev, card: str) -> dict:
    """(a), (b) and (c) above. Returns rank 0's launches of each path."""
    from edgestyle_tpu_torch.core import mesh as M
    from edgestyle_tpu_torch.core.device import make_generator

    rec = {"card": card, "steps": MC_STEPS}
    # (a): NCCL, one rank, in this process
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(M.free_port()))
    try:
        M.init_distributed(dev, backend="nccl")
        mesh = M.make_mesh(M.MeshSpec(data=1, model=1), dev)
        pipe, params, _ = build_pipeline(dev)
        ids, neg, imgs = _mc_request(pipe, dev)
        rec["single_b2_s"], ref2 = _wall(lambda: pipe(
            params, ids, neg, imgs, generator=make_generator(MC_LATENT_SEED, dev),
            num_inference_steps=MC_STEPS), 1)
        rec["single_b1_s"], ref1 = _wall(lambda: pipe(
            params, ids[:1], neg[:1], [im[:1] for im in imgs],
            generator=make_generator(MC_LATENT_SEED, dev), num_inference_steps=MC_STEPS), 1)
        rec["nccl_dp_s"], dp1 = _wall(lambda: pipe.generate_dp(
            mesh, params, ids, neg, imgs, generator=make_generator(MC_LATENT_SEED, dev),
            num_inference_steps=MC_STEPS), 1)
        check_images(dp1, 2, "multicard (a) generate_dp")
        if not torch.equal(dp1, ref2):
            fail(f"multicard (a): NCCL one-rank generate_dp differs from __call__ by "
                 f"{(dp1 - ref2).abs().max().item()}")
        ref2, ref1 = ref2.cpu(), ref1.cpu()
        del pipe, params, dp1
        torch.cuda.empty_cache()

        single = {run: _mc_train_step(dev, None, run) for run in MC_TRAIN_RUNS}
        nccl = _mc_train_step(dev, mesh, "bf16")
        same = all(nccl[k] == single["bf16"][k] for k in ("loss", "d")) and all(
            torch.equal(v, single["bf16"]["after"][k]) for k, v in nccl["after"].items())
        if not same:
            fail("multicard (a): the NCCL one-rank train step differs from the single-process step")
        rec["single_train_s"], rec["nccl_train_s"] = single["bf16"]["s"], nccl["s"]
        torch.cuda.empty_cache()
    finally:
        M._destroy()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
    print(f"multicard (a) NCCL one rank: generate_dp B=2 == __call__ bit for bit, train step "
          f"== single-process step bit for bit (loss {single['bf16']['loss']:.6f}, d "
          f"{single['bf16']['d']:.3e}); single-process B=2 {rec['single_b2_s']:.3f} s, B=1 "
          f"{rec['single_b1_s']:.3f} s, NCCL generate_dp {rec['nccl_dp_s']:.3f} s, train step "
          f"{rec['single_train_s']:.3f} s single / {rec['nccl_train_s']:.3f} s NCCL "
          f"({MC_STEPS} UniPC steps, 512 px, bf16)", flush=True)

    # (b): two gloo ranks on cuda:0 (the kernels were built above)
    t0 = time.perf_counter()
    ranks = M.run_ranks(_multicard_rank, 2, (MC_STEPS,))
    rec["gloo_wall_s"] = time.perf_counter() - t0
    gen_launches = serving_launches(MC_STEPS, range(MC_STEPS), range(MC_STEPS))
    for r in ranks:
        tag = f"multicard (b) rank {r['rank']}"
        check_images(r["dp"], 2, f"{tag} generate_dp")
        check_images(r["tp"], 1, f"{tag} generate_tp")
        if not torch.equal(r["dp"], ranks[0]["dp"]) or not torch.equal(r["tp"], ranks[0]["tp"]):
            fail(f"{tag}: the ranks returned different images")
        dmean, dmax = _level_diff(r["dp"], ref2)
        tmean, tmax = _level_diff(r["tp"], ref1)
        trains = {run: _mc_update_diffs(r["train"][run], single[run]) for run in MC_TRAIN_RUNS}
        per_step = r["tp_bytes"] / MC_STEPS
        print(f"{tag}: generate_dp B=2 {r['dp_s']:.3f} s (rows 1 a rank; two ranks share "
              f"the card), vs single-process B=2 mean {dmean:.4f} max {dmax:.0f} levels; "
              f"generate_tp model=2 B=1 {r['tp_s']:.3f} s, vs single-process B=1 mean "
              f"{tmean:.4f} max {tmax:.0f} levels, {r['all_reduces']} all-reduces (predicted "
              f"{r['all_reduces_predicted']}), {r['tp_bytes']} bytes ({per_step:.0f} a step "
              f"with the prompt encode's share); replicate_params {r['replicate_s']:.3f} s; "
              f"launches dp {r['dp_launches']} tp {r['tp_launches']}", flush=True)
        for run, t in trains.items():
            print(f"{tag}: DP train step {run}: {r['train'][run]['s']:.3f} s (single-process "
                  f"{single[run]['s']:.3f} s), loss {r['train'][run]['loss']:.6f} (single "
                  f"{single[run]['loss']:.6f}), d {r['train'][run]['d']:.3e}, update rel. L2 per "
                  f"group { {g: round(v, 6) for g, v in t['groups'].items()} }, gradient "
                  f"{ {g: round(v, 6) for g, v in t['grads'].items()} }, "
                  f"{r['train'][run]['bytes']} bytes all-reduced, launches "
                  f"{r['train'][run]['launches']}", flush=True)
        if not (dmean <= SERVE_MEAN_TOL and dmax <= SERVE_MAX_TOL):
            fail(f"{tag}: generate_dp off the single-process images by mean {dmean}, max "
                 f"{dmax} levels (tol {SERVE_MEAN_TOL}, {SERVE_MAX_TOL})")
        if not (tmean <= SERVE_MEAN_TOL and tmax <= SERVE_MAX_TOL):
            fail(f"{tag}: generate_tp off the single-process image by mean {tmean}, max "
                 f"{tmax} levels (tol {SERVE_MEAN_TOL}, {SERVE_MAX_TOL})")
        for run, tol, loss_tol in (("bf16", GRAD_TOL, MC_LOSS_TOL),
                                   ("bf16_live", GRAD_TOL, MC_LOSS_TOL),
                                   ("fp32", MC_FP32_TOL, MC_FP32_TOL)):
            t = trains[run]
            held = [*t["grads"].values(), *(t["groups"].values() if run == "bf16" else ())]
            if t["loss"] > loss_tol or t["d"] > loss_tol or not all(v <= tol for v in held):
                fail(f"{tag}: the {run} DP train step off the single-process one: loss and d "
                     f"{t['loss']}, {t['d']} relative (tol {loss_tol}), gradient per group "
                     f"{t['grads']}, update {t['groups']} (tol {tol})")
        if r["all_reduces"] != r["all_reduces_predicted"]:
            fail(f"{tag}: {r['all_reduces']} TP all-reduces, the code predicts "
                 f"{r['all_reduces_predicted']}")
        int8_rec = {}
        for mode, t in r["int8_tp"].items():
            static = mode == "int8-static"
            ref = t["single"]
            # each run records its own table under int8-static
            mean_tol, max_tol = MC_INT8_LEVEL_TOL[mode]
            check_images(t["image"], 1, f"{tag} {mode} generate_tp")
            imean, imax = _level_diff(t["image"], ref["image"])
            int8_rec[mode] = {
                "s": t["s"], "single_s": ref["s"], "levels": [imean, imax],
                "bit_equal": torch.equal(t["image"], ref["image"]), "counts": t["counts"],
                "collectives": t["collectives"]}
            print(f"{tag}: {mode} generate_tp model=2 B=1 {t['s']:.3f} s (single-process "
                  f"{ref['s']:.3f} s), vs this rank's single-process {mode} image mean "
                  f"{imean:.4f} max {imax:.0f} levels (tol {mean_tol}, {max_tol}; bit for bit "
                  f"{int8_rec[mode]['bit_equal']}), int8 products {t['counts']} (single "
                  f"{ref['counts']}), {t['collectives']} model-group collectives (predicted "
                  f"{t['collectives_predicted']})", flush=True)
            if static:
                trel = _table_rel(t["table"], ref["table"])
                frel = _table_rel(t["fault"]["table"], ref["table"])
                smean, smax = _level_diff(t["image"], t["single_on_tp_table"]["image"])
                fmean, fmax = _level_diff(t["fault"]["image"], ref["image"])
                int8_rec[mode].update(
                    table_bit_equal=t["table"] == ref["table"], table_max_rel=trel,
                    fault_table_max_rel=frel, table_entries=len(t["table"]),
                    levels_same_table=[smean, smax], fault_levels=[fmean, fmax])
                print(f"{tag}: int8-static table recorded under TP, {len(t['table'])} keys: "
                      f"bit for bit {t['table'] == ref['table']}, largest relative difference "
                      f"{trel} (tol {MC_INT8_TABLE_TOL}); planted fault (each rank's own "
                      f"absmax) table {frel}, image mean {fmean:.4f} max {fmax:.0f} levels "
                      f"(must leave {mean_tol}, {max_tol}); on the same table (the single "
                      f"process on the TP run's) mean {smean:.4f} max {smax:.0f} levels (read, "
                      f"not held)", flush=True)
            if t["image"].shape != ref["image"].shape or not (
                    imean <= mean_tol and imax <= max_tol):
                fail(f"{tag}: {mode} generate_tp off the single-process image by mean {imean}, "
                     f"max {imax} levels (tol {mean_tol}, {max_tol})")
            if t["counts"] != ref["counts"] or not ref["counts"]["dense"]:
                fail(f"{tag}: {mode} generate_tp ran int8 products {t['counts']}, the single "
                     f"process {ref['counts']}")
            if t["collectives"] != t["collectives_predicted"]:
                fail(f"{tag}: {mode} generate_tp made {t['collectives']} model-group "
                     f"collectives, the code predicts {t['collectives_predicted']}")
            if static and not (isinstance(trel, float) and trel <= MC_INT8_TABLE_TOL):
                fail(f"{tag}: the int8-static table recorded under TP is off the single "
                     f"process's by {trel} (tol {MC_INT8_TABLE_TOL})")
            if static and isinstance(frel, float) and frel <= MC_INT8_TABLE_TOL:
                fail(f"{tag}: the planted fault (each rank's own absmax) passed the table "
                     f"check: {frel}")
            if static and fmean <= mean_tol and fmax <= max_tol:
                fail(f"{tag}: the planted fault (each rank's own absmax) passed the image "
                     f"check: mean {fmean}, max {fmax} levels")
        if r["dp_launches"] != gen_launches or r["tp_launches"] != gen_launches:
            fail(f"{tag}: the generations' launches differ from the prediction {gen_launches}")
        fp32_step = {**TRAIN_LAUNCHES_PER_STEP, "gn_scale_shift": 0, "fused_gn_silu_conv3x3": 0}
        for run, want in (("bf16", TRAIN_LAUNCHES_PER_STEP), ("bf16_live", TRAIN_LAUNCHES_PER_STEP),
                          ("fp32", fp32_step)):
            if r["train"][run]["launches"] != want:
                fail(f"{tag}: the {run} train step's launches differ from the prediction {want}")
            if r["train"][run]["bytes"] != 4 * (sum(
                    v.numel() for v in r["train"][run]["after"].values()) + 1):
                fail(f"{tag}: the {run} train step all-reduced {r['train'][run]['bytes']} "
                     f"bytes, not every gradient and the loss once")
        rec[f"rank{r['rank']}"] = {
            "dp_s": r["dp_s"], "tp_s": r["tp_s"], "dp_levels": [dmean, dmax],
            "tp_levels": [tmean, tmax], "all_reduces": r["all_reduces"],
            "tp_bytes": r["tp_bytes"], "replicate_s": r["replicate_s"], "int8_tp": int8_rec,
            "train": {run: {"s": r["train"][run]["s"], "bytes": r["train"][run]["bytes"], **t}
                      for run, t in trains.items()}}

    # (c): four gloo ranks on cuda:0, the DP x TP train step
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_dptp_")
    atexit.register(shutil.rmtree, ckpt_root, True)
    t0 = time.perf_counter()
    dptp = M.run_ranks(_dptp_rank, 4, (ckpt_root,))
    rec["dptp_wall_s"] = time.perf_counter() - t0
    shutil.rmtree(ckpt_root, True)
    lora_groups = ("lora_0", "lora_1")
    for r in dptp:
        for run, spec in MC_DPTP_RUNS.items():
            t = r["train"][run]
            tag = f"multicard (c) rank {r['rank']} {run} DPxTP{spec} at {t['coords']}"
            diffs = _mc_update_diffs(t, single[run])
            checked = "fault_exp_avg" in t  # the planted fault and the resume
            fault = _mc_update_diffs({**t, "exp_avg": t["fault_exp_avg"]}, single[run]) \
                if checked else None
            tol, loss_tol = (GRAD_TOL, MC_LOSS_TOL) if run.startswith("bf16") else (
                MC_FP32_TOL, MC_FP32_TOL)
            pred = t["predicted"]
            print(f"{tag}: {t['s']:.3f} s a step (single-process {single[run]['s']:.3f} s; four "
                  f"ranks share the card), peak {t['peak_gib']:.2f} GiB a rank, loss "
                  f"{t['loss']:.6f} (single {single[run]['loss']:.6f}), gradient rel. L2 per "
                  f"group { {g: round(v, 6) for g, v in diffs['grads'].items()} }; TP "
                  f"collectives {t['tp']} (predicted {pred}), {t['bytes']} bytes over the "
                  f"mesh; launches {t['launches']}", flush=True)
            if checked:
                print(f"{tag}: planted fault (no model-group sum in the LoRA merge): gradient "
                      f"rel. L2 { {g: round(v, 4) for g, v in fault['grads'].items()} }; save "
                      f"+ resume {t['resume_s']:.2f} s, bit for bit {t['resumed_bit_equal']}",
                      flush=True)
            if diffs["loss"] > loss_tol or diffs["d"] > loss_tol or not all(
                    v <= tol for v in diffs["grads"].values()):
                fail(f"{tag}: off the single-process step: loss and d {diffs['loss']}, "
                     f"{diffs['d']} relative (tol {loss_tol}), gradient per group "
                     f"{diffs['grads']} (tol {tol})")
            if checked and all(fault["grads"][g] <= tol for g in lora_groups):
                fail(f"{tag}: the planted fault (no model-group sum of the LoRA merge) passed "
                     f"the gradient check: {fault['grads']}")
            if t["tp"] != pred:
                fail(f"{tag}: TP collectives {t['tp']}, the code predicts {pred}")
            if checked and not t["resumed_bit_equal"]:
                fail(f"{tag}: the sharded resume differs from the saved state")
            if not all(torch.equal(v, dptp[0]["train"][run]["after"][k])
                       for k, v in t["after"].items()):
                fail(f"{tag}: the trainables differ from rank 0's")
            want = TRAIN_LAUNCHES_PER_STEP if run.startswith("bf16") else {
                **TRAIN_LAUNCHES_PER_STEP, "gn_scale_shift": 0, "fused_gn_silu_conv3x3": 0}
            if t["launches"] != want:
                fail(f"{tag}: launches {t['launches']}, the prediction {want}")
            rec[f"dptp_rank{r['rank']}_{run}"] = {
                "spec": list(spec), "coords": list(t["coords"]), "s": t["s"],
                "peak_gib": t["peak_gib"], "loss": diffs["loss"], "d": diffs["d"],
                "grads": diffs["grads"], "fault_grads": fault and fault["grads"],
                "tp": t["tp"], "resume_s": t.get("resume_s"), "mesh_bytes": t["bytes"]}
    print(json.dumps({"multicard": rec}), flush=True)
    return {"generate_dp": ranks[0]["dp_launches"], "generate_tp": ranks[0]["tp_launches"],
            "dp_training": ranks[0]["train"]["bf16"]["launches"],
            "dptp_training": dptp[0]["train"]["bf16_live"]["launches"]}


# ------------------------------------------------------------------- zoo
# The EfficientViT model zoo (models/efficientvit/zoo.py): seg and cls
# models at their data sets' sizes, fp32 with TF32 off, seeded weights;
# the card against the same code on the CPU within ZOO_REL_TOL of the
# largest |logit| (the fp32 SAM-L2 check's limit: convolutions sum in
# another order), and each port function on an upstream-named state dict
# synthesised from the tree, bit for bit.
ZOO_MODELS = [("seg", "b1", "cityscapes", 512), ("seg", "l2", "ade20k", 512),
              ("cls", "b3", None, 224), ("cls", "l2", None, 224)]
ZOO_REL_TOL = 1e-4
ZOO_TIMED = 5


def zoo_phase(dev, card: str) -> None:
    from edgestyle_tpu_torch.core.device import make_generator
    from edgestyle_tpu_torch.models.efficientvit import zoo

    rec = {"card": card, "models": {}}
    bad = []
    for kind, name, dataset, size in ZOO_MODELS:
        model, port = (zoo.create_seg_model(name, dataset) if kind == "seg"
                       else zoo.create_cls_model(name))
        params = model.init_params(make_generator(0, dev))
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        x = torch.randn((1, 3, size, size), generator=g, device=dev)
        with torch.no_grad():
            out = model(params, x)
            ms, out = _wall(lambda: model(params, x), ZOO_TIMED)
            cpu = model(_to(params, "cpu"), x.cpu())
        err = (out.cpu() - cpu).abs().max().item() / cpu.abs().max().item()
        back = port(upstream_state_dict(params, port.rules), dev)
        same = _trees_equal(back, params)
        tag = f"{kind} {name}" + (f" {dataset}" if dataset else "")
        r = {"size": size, "out": list(out.shape), "ms": ms * 1e3, "card_vs_cpu_rel": err,
             "port_bit_equal": same, "finite": bool(torch.isfinite(out).all()),
             "params": sum(v.numel() for v in _leaves(params))}
        rec["models"][tag] = r
        print(f"zoo {tag} ({card}): {size} px fp32, out {tuple(out.shape)}, {r['params']} params, "
              f"{r['ms']:.3f} ms a forward (median of {ZOO_TIMED}), card vs CPU {err:.3e} of the "
              f"largest |logit| (tol {ZOO_REL_TOL}), port_fn on the synthesised upstream state "
              f"dict bit for bit {same}", flush=True)
        if not (r["finite"] and err <= ZOO_REL_TOL and same):
            bad.append(f"{tag}: finite {r['finite']}, card vs CPU {err}, port {same}")
        del params, back
        torch.cuda.empty_cache()
    print(json.dumps({"zoo": rec}), flush=True)
    if bad:
        fail("zoo: " + "; ".join(bad))


def _leaves(tree):
    from edgestyle_tpu_torch.core.params import flatten

    return flatten(tree).values()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one B=1 generation, one request of each serving run "
                         "and one training step; write the tables under DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py needs one GPU",
              flush=True)
        return 2
    try:
        from edgestyle_tpu_torch import kernels
    except ImportError as e:
        print(f"FAIL: the port package is not beside chip_smoke.py ({e})", flush=True)
        return 2
    if not os.path.abspath(kernels.__file__).startswith(os.path.join(HERE, "")):
        print(f"FAIL: imported the port from {kernels.__file__}, not from beside "
              f"chip_smoke.py", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.library, kernels.SOURCES))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in kernels.SOURCES:
        log = kernels.build_log(name)
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    records = kernel_phase(dev)
    t0 = time.perf_counter()
    pipe, params, gen = build_pipeline(dev)
    torch.cuda.synchronize()
    print(f"pipeline init (full-width SD1.5, bf16): {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches = generation_phase(dev, pipe, params, gen)
    if args.profile:
        profile_phase(dev, pipe, params, gen, args.profile)
    e2e_phase(dev, pipe, params, gen)
    tryon_launches = tryon_system_phase(dev, pipe, params, card)
    serving_launches_total = serving_phase(dev, pipe, params, gen, card, args.profile)
    t0 = time.perf_counter()
    int8_launches, int8_table = int8_phase(dev, pipe, params, gen, card)
    print(f"phase int8: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    serve_launches = serve_phase(dev, pipe, params, card, int8_table)
    print(f"phase serve: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    export_launches = export_phase(dev, pipe, params, gen, card)
    print(f"phase export: {time.perf_counter() - t0:.2f} s", flush=True)
    del pipe, params
    torch.cuda.empty_cache()

    train_launches, built, synthetic_step_s = training_phase(dev)
    grad_check_phase(dev, built)
    if args.profile:
        profile_train_step(dev, built, args.profile)
    del built
    fp32_training_phase(dev)
    torch.cuda.empty_cache()
    pretrained_tryon_launches, pretrained_train_launches = pretrained_phase(dev, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the CLIP files serve mined_tryon and, at the end, extract
    clip_root = tempfile.mkdtemp(prefix="chip_smoke_clip_")
    atexit.register(shutil.rmtree, clip_root, True)
    clip_files = write_clip_files(clip_root, dev)
    mined_launches = mined_tryon_phase(dev, card, clip_files)
    print(f"phase mined_tryon: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data_launches, trained = data_training_phase(dev, card, synthetic_step_s)
    print(f"phase data_training: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    validation_launches = validation_phase(dev, card, trained)
    print(f"phase validation: {time.perf_counter() - t0:.2f} s", flush=True)
    del trained
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    distill_launches_by_run, lcm_file, built = distill_phase(dev, card)
    print(f"phase distill: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    distill_grad_check_phase(dev, built)
    print(f"phase distill_grad_check: {time.perf_counter() - t0:.2f} s", flush=True)
    del built
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lcm_launches = lcm_serving_phase(dev, card, lcm_file)
    print(f"phase lcm_serving: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    infer_launches = infer_phase(dev, card)
    print(f"phase infer: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    seg_launches = segmenter_phase(dev, card)
    print(f"phase segmenter: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    auto_launches = auto_mask_phase(dev, card)
    print(f"phase auto_mask: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    extract_launches = extract_phase(dev, card, clip_files)
    print(f"phase extract: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multicard_launches = multicard_phase(dev, card)
    print(f"phase multicard: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    zoo_phase(dev, card)
    print(f"phase zoo: {time.perf_counter() - t0:.2f} s", flush=True)

    # each kernel's path: the generation for the forward kernels, training
    # for the backward ones (which generation never runs)
    paths = {"flash_fwd": "generation", "gn_scale_shift": "generation",
             "fused_gn_silu_conv3x3": "generation", "flash_bwd_dq": "training",
             "flash_bwd_dkv": "training"}
    by_path = {"generation": launches, "tryon_system": tryon_launches,
               "serving": serving_launches_total, "int8": int8_launches,
               "serve": serve_launches, "export": export_launches, "training": train_launches,
               "pretrained_tryon": pretrained_tryon_launches,
               "pretrained_training": pretrained_train_launches, "mined_tryon": mined_launches,
               "data_training": data_launches, "validation": validation_launches,
               **distill_launches_by_run, "lcm_serving": lcm_launches, **infer_launches,
               "segmenter": seg_launches, "auto_mask": auto_launches,
               "extract": extract_launches, **multicard_launches}
    out = []
    for name, source, replaces, shapes in records:
        # the record's bound is the largest shape's; exponentials are
        # operations too (on the SFU), and each shape names its own bound
        top_by = max(shapes, key=lambda s: s["bound_ms"])["bound_by"]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=by_path[paths[name]][name],
            launches_by_path={p: counts[name] for p, counts in by_path.items()},
            max_abs_err=max(s["max_abs_err"] for s in shapes),
            ms=sum(s["ms"] for s in shapes),
            plain_ms=sum(s["plain_ms"] for s in shapes),
            bound_ms=sum(s["bound_ms"] for s in shapes),
            bound_by=top_by if top_by != "exp" else "operations",
            library_ms=sum(s["library_ms"] for s in shapes),
            shapes=shapes,
        ))
        if by_path[paths[name]][name] == 0:
            fail(f"kernel {name} was never launched on its path ({paths[name]})")
        if by_path["distill_consistency"][name] == 0:
            fail(f"kernel {name} was never launched on the distiller's path")
        if by_path["dp_training"][name] == 0:
            fail(f"kernel {name} was never launched on the data-parallel train step")
        if by_path["dptp_training"][name] == 0:
            fail(f"kernel {name} was never launched on the DP x TP train step")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

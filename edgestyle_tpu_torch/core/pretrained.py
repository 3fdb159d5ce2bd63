"""Pipeline params from diffusers/HF checkpoint directories on disk.

Counterpart of edgestyle_tpu/core/pretrained.py. The reference loads
(SURVEY.md §2.6):

  * SG161222/Realistic_Vision_V5.1_noVAE: ``unet/`` and ``text_encoder/``;
  * stabilityai/sd-vae-ft-mse: the VAE;
  * lllyasviel/control_v11p_sd15_openpose: the frozen ControlNet.

Given local copies of those (the diffusers directory layout, with
``diffusion_pytorch_model.safetensors`` or ``model.safetensors``), the
loaders here build the tree that ``EdgeStylePipeline.init_params`` gives,
with the same keys. Each file is read to the device in its own dtype by the
port's reader (core/safetensors.py), renamed by its model's mapper and
cast on the device (core/porting.py::tree_from_flat: norms fp32, the rest
the compute dtype, 4-D leaves channels_last). Nothing is downloaded.

The reference's trained-EdgeStyle directory (fusion blocks at the top,
``controlnet_{0,1}/`` with each ControlLoRA's heads and adapters) is read
by :func:`load_edgestyle_pretrained_dir` and written by
:func:`export_reference_layout`, its exact inverse.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from edgestyle_tpu_torch.core.device import DeviceLike, make_generator, resolve_device
from edgestyle_tpu_torch.core.params import flatten
from edgestyle_tpu_torch.core.porting import KeyMapper, tree_from_flat
from edgestyle_tpu_torch.core.safetensors import load_file, save_file
from edgestyle_tpu_torch.models.clip_text import port_clip_text_state_dict
from edgestyle_tpu_torch.models.clip_vision import port_clip_vision_state_dict
from edgestyle_tpu_torch.models.unet import (
    _unet_common_mapper,
    controllora_params,
    port_controlnet_state_dict,
    port_unet_state_dict,
)
from edgestyle_tpu_torch.models.vae import port_vae_state_dict

WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "pytorch_model.safetensors")


def _find_weights(path: str) -> str:
    for name in WEIGHT_FILES:
        p = os.path.join(path, name)
        if os.path.isfile(p):
            return p
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(f"no safetensors weights under {path}")


def _load(path: str, mapper, device: DeviceLike, dtype: torch.dtype) -> Dict:
    dev = resolve_device(device)
    return tree_from_flat(mapper(load_file(_find_weights(path), dev)), dev, dtype)


def load_vae_params(path: str, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    return _load(path, port_vae_state_dict, device, dtype)


def load_clip_text_params(path: str, num_layers: int = 12, device: DeviceLike = "cuda",
                          dtype: torch.dtype = torch.bfloat16) -> Dict:
    return _load(path, lambda sd: port_clip_text_state_dict(sd, num_layers), device, dtype)


def load_clip_model_params(path: str, text_layers: int = 12, vision_layers: int = 24,
                           device: DeviceLike = "cuda",
                           dtype: torch.dtype = torch.float32) -> Dict:
    """A dual-tower CLIPModel checkpoint (the openai/clip-vit-large-patch14
    layout: the reference's prompt-mining model, inference.py:98-99) ->
    {"text": ..., "vision": ...}, the trees of
    ``CLIPTextModelWithProjection`` and ``CLIPVisionModelWithProjection``.
    ``logit_scale`` and the ``position_ids`` buffers are dropped."""
    dev = resolve_device(device)
    sd = load_file(_find_weights(path), dev)
    text = {f"text_model.{k}": v for k, v in port_clip_text_state_dict(
        {k: v for k, v in sd.items() if k.startswith("text_model.")}, text_layers).items()}
    text["text_projection.kernel"] = sd["text_projection.weight"]
    vision = port_clip_vision_state_dict(
        {k: v for k, v in sd.items() if k.startswith(("vision_model.", "visual_projection"))},
        vision_layers)
    return {"text": tree_from_flat(text, dev, dtype), "vision": tree_from_flat(vision, dev, dtype)}


def load_unet_params(path: str, device: DeviceLike = "cuda",
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
    return _load(path, port_unet_state_dict, device, dtype)


def load_controlnet_params(path: str, device: DeviceLike = "cuda",
                           dtype: torch.dtype = torch.bfloat16) -> Dict:
    return _load(path, port_controlnet_state_dict, device, dtype)


def _cast(tree: Dict, device, dtype: torch.dtype) -> Dict:
    return tree_from_flat({".".join(k): v for k, v in flatten(tree).items()}, device, dtype)


def load_pipeline_params(pretrained_model_dir: str, vae_dir: str, openpose_controlnet_dir: str,
                         edgestyle_checkpoint: Optional[str] = None, lora_rank: int = 32, *,
                         pipe, generator: Optional[torch.Generator] = None) -> Dict:
    """The params of ``pipe`` (an ``EdgeStylePipeline``: its config, dtype
    and device) from the three HF-layout directories.

    ``edgestyle_checkpoint``: the trained trainable set, as a
    reference-layout directory (:func:`load_edgestyle_pretrained_dir`) or a
    flat file (``training/checkpoint.py::export_safetensors``, the JAX
    package's layout). Without it, fresh adapters of ``lora_rank`` and a
    fresh fusion are drawn from ``generator`` (default seed 0 on the
    pipeline's device) and the heads are zero, as ``init_trainable`` makes
    them. Each ControlLoRA branch is the UNet's trunk with its adapters
    merged and its heads, and carries the static net's cond embedding
    (shared, not copied), as ``init_params``'s tree does."""
    from edgestyle_tpu_torch.training.checkpoint import import_safetensors
    from edgestyle_tpu_torch.training.train_step import init_trainable

    missing = [flag for flag, d in (("--pretrained_model", pretrained_model_dir),
                                    ("--vae", vae_dir),
                                    ("--openpose_controlnet", openpose_controlnet_dir)) if not d]
    if missing:
        raise ValueError(f"the pipeline's weights need three directories (--pretrained_model, "
                         f"--vae, --openpose_controlnet); missing {', '.join(missing)}")
    dev, dtype, cfg = pipe.device, pipe.dtype, pipe.cfg
    unet = load_unet_params(os.path.join(pretrained_model_dir, "unet"), dev, dtype)
    clip = load_clip_text_params(os.path.join(pretrained_model_dir, "text_encoder"),
                                 cfg.clip.num_layers, dev, dtype)
    vae = load_vae_params(vae_dir, dev, dtype)
    static = load_controlnet_params(openpose_controlnet_dir, dev, dtype)

    if edgestyle_checkpoint and os.path.isdir(edgestyle_checkpoint):
        tr = load_edgestyle_pretrained_dir(edgestyle_checkpoint, dev)
    elif edgestyle_checkpoint:
        tr = import_safetensors(edgestyle_checkpoint, dev)
    else:
        gen = generator if generator is not None else make_generator(0, dev)
        tr = init_trainable(pipe, gen, unet, lora_rank)
    cond = {"controlnet_cond_embedding": static["controlnet_cond_embedding"]}
    controlnet = {"static": static, "fusion": _cast(tr["fusion"], dev, dtype)}
    for key in sorted({g.params_key for g in pipe.mcn.groups if g.kind == "lora"}):
        i = key.split("_")[1]
        heads = _cast(tr[f"heads_{i}"], dev, dtype)
        controlnet[key] = controllora_params(unet, tr[f"lora_{i}"], {**heads, **cond})
    return {"vae": vae, "clip": clip, "unet": unet, "controlnet": controlnet}


# ----------------------------------------------------- reference EdgeStyle
# The reference trainer's final save (train_text2image_pretrained_openpose
# .py:1373-1382 and EdgeStyleMultiControlNetModel.save_pretrained,
# edgestyle_multicontrolnet.py:213-282) is a directory:
#   diffusion_pytorch_model.safetensors              the fusion blocks only
#   controlnet_0/diffusion_pytorch_model.safetensors ControlLoRA "A"
#   controlnet_1/diffusion_pytorch_model.safetensors ControlLoRA "B"
# each ControlLoRA file holding only its untied modules and its
# ".lora_layer." weights (controllora.py:600-606). Torch's layouts are the
# port's, with one exception: diffusers' LoRAConv2dLayer ends in a 1x1 conv,
# up (out, r, 1, 1), where the port keeps up (out, r). The fusion's grouped
# 1x1 convs (out, in / groups, 1, 1) and its LayerNorm([C, H, W]) params
# (C, H, W) are the port's layouts already.
def port_fusion_state_dict(sd) -> Dict:
    """The reference EdgeStyleMultiControlNetModel's state dict -> flat
    {path: leaf} of the fusion tree."""
    m = KeyMapper()
    for base, tgt in ((r"multi_controlnet_down_blocks\.(\d|1[01])",
                       r"multi_controlnet_down_blocks_\1"),
                      (r"(multi_controlnet_mid_block)", r"\1")):
        m.module(base + r"\.(first_conv|second_conv|third_conv)", tgt + r".\2")
        m.norm(base + r"\.(first_normalization|second_normalization)", tgt + r".\2")
    return m.apply(sd)


def _squeeze_up(v):
    return v[:, :, 0, 0] if v.ndim == 4 else v


def port_controllora_state_dict(sd) -> Tuple[Dict, Dict]:
    """A reference ControlLoRAModel's state dict (its untied modules and
    LoRA weights) -> (flat adapters {kernel path.down/up: leaf}, flat
    zero-conv heads {path: leaf}).

    An adapter's key is its trunk module's with ``.lora_layer.{down,up}``
    in place of the weight, so each trunk kernel rule gives its two
    adapter rules. The tied trunk is absent by construction: tying is
    structural here (the UNet's trunk is passed at assembly). The cond
    embedding's keys duplicate the tied UNet's conv_in and are dropped."""
    m = KeyMapper()
    for pat, template, _ in _unet_common_mapper(KeyMapper()).rules:
        if template.endswith(".kernel"):
            base = pat.pattern[:-len(r"\.weight")]
            m.rule(base + r"\.lora_layer\.down\.weight", template + ".down")
            m.rule(base + r"\.lora_layer\.up\.weight", template + ".up", _squeeze_up)
    m.module(r"controlnet_down_blocks\.(\d|1[01])", r"controlnet_down_blocks_\1")
    m.module(r"controlnet_mid_block", "controlnet_mid_block")
    m.rule(r"controlnet_cond_embedding\..*", None)
    flat = m.apply(sd)
    lora = {k: v for k, v in flat.items() if k.endswith((".down", ".up"))}
    return lora, {k: v for k, v in flat.items() if k not in lora}


def load_edgestyle_pretrained_dir(path: str, device: DeviceLike = "cuda") -> Dict:
    """A reference-layout trained-EdgeStyle directory -> the trainable set
    {lora_0, heads_0, lora_1, heads_1, fusion}, fp32 on ``device`` (the
    layout ``init_trainable`` gives)."""
    dev = resolve_device(device)
    out = {"fusion": tree_from_flat(port_fusion_state_dict(
        load_file(_find_weights(path), dev)), dev)}
    for i in (0, 1):
        lora, heads = port_controllora_state_dict(
            load_file(_find_weights(os.path.join(path, f"controlnet_{i}")), dev))
        out[f"lora_{i}"] = tree_from_flat(lora, dev)
        out[f"heads_{i}"] = tree_from_flat(heads, dev)
    return out


def _trunk_inverse_index() -> Dict[str, str]:
    """The port's trunk kernel path -> the torch module it comes from, made
    by running the torch names of every LoRA target through the forward
    mapper (no inverse rules to keep in step)."""
    cands = ["time_embedding.linear_1", "time_embedding.linear_2", "conv_in"]

    def attn_unit(base):
        out = []
        for a in ("attn1", "attn2"):
            out += [f"{base}.{a}.{t}" for t in ("to_q", "to_k", "to_v")]
            out.append(f"{base}.{a}.to_out.0")
        return out + [f"{base}.ff.net.0.proj", f"{base}.ff.net.2"]

    for i in range(4):
        for j in range(3):
            ab, rb = f"down_blocks.{i}.attentions.{j}", f"down_blocks.{i}.resnets.{j}"
            cands += [f"{ab}.proj_in", f"{ab}.proj_out", f"{rb}.time_emb_proj"]
            # conv-LoRA targets: every trunk conv is a LoRACompatibleConv in
            # the reference (controllora.py:561)
            cands += [f"{rb}.conv1", f"{rb}.conv2", f"{rb}.conv_shortcut"]
            for k in range(2):
                cands += attn_unit(f"{ab}.transformer_blocks.{k}")
        cands.append(f"down_blocks.{i}.downsamplers.0.conv")
    for j in range(2):
        rb = f"mid_block.resnets.{j}"
        cands += [f"{rb}.conv1", f"{rb}.conv2", f"{rb}.conv_shortcut", f"{rb}.time_emb_proj"]
    cands += ["mid_block.attentions.0.proj_in", "mid_block.attentions.0.proj_out"]
    for k in range(2):
        cands += attn_unit(f"mid_block.attentions.0.transformer_blocks.{k}")

    m = _unet_common_mapper(KeyMapper())
    return {m.match(base + ".weight")[0]: base for base in cands}


def export_reference_layout(path: str, trainable: Dict, unet_conv_in: Optional[Dict] = None
                            ) -> str:
    """Write the trainable set in the reference's final-save layout
    (train...py:1373-1382), so that a user of the reference stack can take
    training done here: the fusion file at the top and ``controlnet_{0,1}/``
    with each ControlLoRA's heads and adapters. The exact inverse of
    :func:`load_edgestyle_pretrained_dir`.

    ``unet_conv_in``: the tied UNet conv_in's {'kernel', 'bias'}, written as
    ``controlnet_cond_embedding.conv_vae_out.*`` (the reference's
    VAEControlNetConditioningEmbedding attribute, controllora.py:36, the
    same Parameter as the tied conv_in), so that the reference's strict
    ``load_state_dict`` finds every untied key."""
    os.makedirs(path, exist_ok=True)
    fusion_sd = {}
    for blk_name, blk in trainable["fusion"].items():
        tname = blk_name.replace("multi_controlnet_down_blocks_", "multi_controlnet_down_blocks.")
        for sub_name, p in blk.items():
            w = p["kernel"] if sub_name.endswith("_conv") else p["scale"]
            fusion_sd[f"{tname}.{sub_name}.weight"] = w
            fusion_sd[f"{tname}.{sub_name}.bias"] = p["bias"]
    save_file(fusion_sd, os.path.join(path, WEIGHT_FILES[0]), metadata={"format": "pt"})

    inverse = _trunk_inverse_index()
    for i in (0, 1):
        sd = {}
        for hname, p in trainable[f"heads_{i}"].items():
            tname = hname.replace("controlnet_down_blocks_", "controlnet_down_blocks.")
            sd[f"{tname}.weight"] = p["kernel"]
            sd[f"{tname}.bias"] = p["bias"]
        lora = flatten(trainable[f"lora_{i}"])
        for key, v in lora.items():
            *kernel, which = key
            base = inverse.get(".".join(kernel))
            if base is None or which not in ("down", "up"):
                raise KeyError(f"no torch mapping for lora leaf {'.'.join(key)}")
            if which == "up" and lora[(*kernel, "down")].ndim == 4:
                v = v[:, :, None, None]  # a conv adapter's up is diffusers' 1x1 conv
            sd[f"{base}.lora_layer.{which}.weight"] = v
        if unet_conv_in is not None:
            sd["controlnet_cond_embedding.conv_vae_out.weight"] = unet_conv_in["kernel"]
            sd["controlnet_cond_embedding.conv_vae_out.bias"] = unet_conv_in["bias"]
        sub_dir = os.path.join(path, f"controlnet_{i}")
        os.makedirs(sub_dir, exist_ok=True)
        save_file(sd, os.path.join(sub_dir, WEIGHT_FILES[0]), metadata={"format": "pt"})
    return path


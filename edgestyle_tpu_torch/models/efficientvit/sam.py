"""EfficientViT-SAM: neck, image encoder, prompt encoder and mask decoder.

Counterpart of edgestyle_tpu/models/efficientvit/sam.py:39-400 (reference
efficientvit/models/efficientvit/sam.py, SamNeck :109-171, image encoder
:174-190, model constructors :517-595, plus segment_anything's PromptEncoder,
MaskDecoder and TwoWayTransformer). EdgeStyle runs five decodes per photo
(the base decoder and four finetuned heads: subject, agnostic, clothes,
head) on one image encoding, so the decoder is cheap to re-run with
another head's params.

Prompts are fixed-size: (B, P, 2) points in the 1024 prompt frame with
labels (B, P): 1 positive, 0 negative, -1 padding, 2/3 the box corners.
The neck resizes every stage to a fixed 64 x 64 grid, whatever the image
size, as the JAX module does; the prompt encoder's grid and the decoder's
64 x 64 token grid are the same constant.

Types: the image encoder computes in the model's ``dtype`` (bf16 in the
try-on app) and returns its embedding in that type; the prompt encoder and
the mask decoder run in fp32 (the JAX modules have no dtype of their own
and the embedding is promoted by the dense prompt), with the decoder
attention's own fp32 softmax, not ops/attention.py.

Automatic mask generation (``automatic_mask_candidates``,
``select_auto_masks``) serves only the dataset extractor and is not ported
yet (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core.params import InitTree, materialize, param, sub
from edgestyle_tpu_torch.models.efficientvit.backbone import (
    L0,
    L1,
    L2,
    BackboneConfig,
    EfficientViTLargeBackbone,
)
from edgestyle_tpu_torch.models.efficientvit.ops import (
    conv_layer,
    fused_mb_conv,
    layer_norm_2d,
)
from edgestyle_tpu_torch.models.layers import dense, from_tokens, layer_norm_block, to_tokens
from edgestyle_tpu_torch.ops.resize import linear_resize, torch_bicubic_resize

GRID = 64  # the neck's output grid, the prompt grid and the decoder's token grid
EMBED = 256


# --------------------------------------------------------------------- neck
def sam_neck(p, feats: Dict[str, torch.Tensor], head_depth: int = 12, head_width: int = 256,
             out_dim: int = 256, fids=("stage4", "stage3", "stage2"),
             norm_eps: float = 1e-6, dtype=torch.float32) -> torch.Tensor:
    """{stage4, stage3, stage2} -> 1x1 conv (+bn) each -> torch bicubic to
    64 x 64 -> sum -> ``head_depth`` residual FusedMBConv blocks -> 1x1 out
    conv."""
    merged = None
    for fid in fids:
        y = conv_layer(sub(p, f"input_{fid}"), feats[fid], head_width, 1, norm="bn", act=None,
                       norm_eps=norm_eps, dtype=dtype)
        y = torch_bicubic_resize(y, (GRID, GRID))
        merged = y if merged is None else merged + y
    x = merged
    for j in range(head_depth):
        x = x + fused_mb_conv(sub(p, f"middle_{j}"), x, head_width, expand_ratio=1,
                              norm=("bn", "bn"), act=("gelu", None), norm_eps=norm_eps,
                              dtype=dtype)
    return conv_layer(sub(p, "output_sam_encoder"), x, out_dim, 1, use_bias=True, norm=None,
                      act=None, dtype=dtype)


def sam_image_encoder(p, x, backbone_cfg: BackboneConfig = L2, neck_depth: int = 12,
                      norm_eps: float = 1e-6, dtype=torch.float32) -> torch.Tensor:
    feats = EfficientViTLargeBackbone(backbone_cfg, norm_eps, dtype)(sub(p, "backbone"), x)
    y = sam_neck(sub(p, "neck"), feats, head_depth=neck_depth, norm_eps=norm_eps, dtype=dtype)
    return layer_norm_2d(sub(p, "norm"), y, norm_eps)


# ------------------------------------------------------------- prompt encoder
def _fourier_pe(p, coords01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of [0, 1] coords (..., 2)."""
    g = param(p, "pe_gaussian", (2, EMBED // 2), "normal")
    proj = (2.0 * math.pi) * torch.matmul(2.0 * coords01 - 1.0, g)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def dense_pe(p, device) -> torch.Tensor:
    """(64 * 64, 256) positional encoding of the grid's cell centres, row-major (y, x)."""
    xs = (torch.arange(GRID, dtype=torch.float32, device=device) + 0.5) / GRID
    grid = torch.stack(torch.meshgrid(xs, xs, indexing="xy"), dim=-1)  # (g, g, 2) x, y
    return _fourier_pe(p, grid).reshape(GRID * GRID, EMBED)


def prompt_encoder(p, points: torch.Tensor, labels: torch.Tensor, input_size: int = 1024):
    """-> sparse (B, P, 256) embeddings, dense (B, 256, 64, 64)."""
    pe = _fourier_pe(p, (points.float() + 0.5) / input_size)
    point_emb = param(p, "point_embeddings", (4, EMBED), "normal")
    nap = param(p, "not_a_point_embed", (EMBED,), "normal")
    no_mask = param(p, "no_mask_embed", (EMBED,), "normal")
    lbl = labels[..., None]
    emb = torch.where(lbl == -1, nap, pe)
    for i in range(4):
        emb = emb + torch.where(lbl == i, point_emb[i], torch.zeros((), device=emb.device))
    b = points.shape[0]
    return emb, no_mask[None, :, None, None].expand(b, EMBED, GRID, GRID)


def boxes_to_points(boxes: torch.Tensor):
    """(B, 4) xyxy -> points (B, 2, 2), labels (B, 2) = (2, 3)."""
    pts = torch.stack([boxes[:, :2], boxes[:, 2:]], dim=1)
    lbl = torch.tensor([2, 3], device=boxes.device).expand(boxes.shape[0], 2)
    return pts, lbl


# ------------------------------------------------------------- mask decoder
def mlp(p, x, hidden: int, out: int, depth: int) -> torch.Tensor:
    for i in range(depth - 1):
        x = F.relu(dense(sub(p, f"layers_{i}"), x, hidden, torch.float32))
    return dense(sub(p, f"layers_{depth - 1}"), x, out, torch.float32)


def attention(p, q, k, v, embed_dim: int = EMBED, num_heads: int = 8,
              downsample_rate: int = 1) -> torch.Tensor:
    """SAM's decoder attention, projections to embed_dim / downsample_rate,
    fp32 softmax."""
    d = embed_dim // downsample_rate
    dt = torch.float32
    hq = dense(sub(p, "q_proj"), q, d, dt)
    hk = dense(sub(p, "k_proj"), k, d, dt)
    hv = dense(sub(p, "v_proj"), v, d, dt)
    b, nq, _ = hq.shape
    nk = hk.shape[1]
    hd = d // num_heads
    qh = hq.reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = hk.reshape(b, nk, num_heads, hd).transpose(1, 2)
    vh = hv.reshape(b, nk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(2, 3)) / math.sqrt(hd)
    probs = torch.softmax(logits.float(), dim=-1).to(vh.dtype)
    o = torch.matmul(probs, vh).transpose(1, 2).reshape(b, nq, d)
    return dense(sub(p, "out_proj"), o, embed_dim, dt)


def two_way_attention_block(p, queries, keys, query_pe, key_pe, skip_first_layer_pe: bool,
                            mlp_dim: int = 2048, norm_eps: float = 1e-6):
    if skip_first_layer_pe:
        queries = attention(sub(p, "self_attn"), queries, queries, queries)
    else:
        q = queries + query_pe
        queries = queries + attention(sub(p, "self_attn"), q, q, queries)
    queries = layer_norm_block(sub(p, "norm1"), queries, norm_eps)

    q, k = queries + query_pe, keys + key_pe
    queries = queries + attention(sub(p, "cross_attn_token_to_image"), q, k, keys,
                                  downsample_rate=2)
    queries = layer_norm_block(sub(p, "norm2"), queries, norm_eps)

    h = dense(sub(p, "mlp_lin1"), queries, mlp_dim, torch.float32)
    h = dense(sub(p, "mlp_lin2"), F.relu(h), EMBED, torch.float32)
    queries = layer_norm_block(sub(p, "norm3"), queries + h, norm_eps)

    q, k = queries + query_pe, keys + key_pe
    keys = keys + attention(sub(p, "cross_attn_image_to_token"), k, q, queries,
                            downsample_rate=2)
    keys = layer_norm_block(sub(p, "norm4"), keys, norm_eps)
    return queries, keys


def two_way_transformer(p, image_embedding, image_pe, point_embedding, depth: int = 2,
                        mlp_dim: int = 2048, norm_eps: float = 1e-6):
    """image_embedding (B, C, 64, 64), image_pe (64 * 64, C), point_embedding
    (B, T, C) -> (queries (B, T, C), keys (B, 64 * 64, C))."""
    keys = to_tokens(image_embedding)
    key_pe = image_pe[None].expand_as(keys)
    queries = point_embedding
    for i in range(depth):
        queries, keys = two_way_attention_block(sub(p, f"layers_{i}"), queries, keys,
                                                point_embedding, key_pe, i == 0, mlp_dim,
                                                norm_eps)
    q, k = queries + point_embedding, keys + key_pe
    queries = queries + attention(sub(p, "final_attn_token_to_image"), q, k, keys,
                                  downsample_rate=2)
    return layer_norm_block(sub(p, "norm_final_attn"), queries, norm_eps), keys


def conv_transpose_2x2(p, x, out_channels: int) -> torch.Tensor:
    """nn.ConvTranspose(k=2, stride 2); kernel in torch's (in, out, kH, kW)."""
    w = param(p, "kernel", (x.shape[1], out_channels, 2, 2))
    b = param(p, "bias", (out_channels,), "zeros")
    return F.conv_transpose2d(x, w.float(), b.float(), stride=2)


def mask_decoder(p, image_embeddings, image_pe, sparse, dense_prompt,
                 multimask_output: bool = True, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, norm_eps: float = 1e-6):
    """image_embeddings (B, 256, 64, 64) in any float type; sparse (B, P,
    256); dense (B, 256, 64, 64). Returns fp32 (masks (B, M, 256, 256)
    logits, iou (B, M)): M = 3 with multimask_output, else 1."""
    n_tokens = num_multimask_outputs + 1
    iou_token = param(p, "iou_token", (1, EMBED), "normal")
    mask_tokens = param(p, "mask_tokens", (n_tokens, EMBED), "normal")
    b = sparse.shape[0]
    out_tokens = torch.cat([iou_token, mask_tokens], dim=0).float()
    tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse.float()], dim=1)
    src = image_embeddings.float() + dense_prompt.float()

    hs, src_out = two_way_transformer(sub(p, "transformer"), src, image_pe, tokens,
                                      norm_eps=norm_eps)
    iou_tok_out = hs[:, 0]
    mask_toks_out = hs[:, 1:1 + n_tokens]

    up = conv_transpose_2x2(sub(p, "upscale_conv1"), from_tokens(src_out, GRID, GRID), 64)
    up = F.gelu(layer_norm_2d(sub(p, "upscale_norm"), up, norm_eps))
    up = F.gelu(conv_transpose_2x2(sub(p, "upscale_conv2"), up, 32))  # (B, 32, 256, 256)

    hyper = torch.stack([mlp(sub(p, f"hyper_mlps_{i}"), mask_toks_out[:, i], 256, 32, 3)
                         for i in range(n_tokens)], dim=1)  # (B, M, 32)
    masks = torch.einsum("bmc,bchw->bmhw", hyper, up)
    iou_pred = mlp(sub(p, "iou_mlp"), iou_tok_out, 256, n_tokens, iou_head_depth)
    if multimask_output:
        return masks[:, 1:], iou_pred[:, 1:]
    return masks[:, :1], iou_pred[:, :1]


# ---------------------------------------------------------------- assembly
@dataclasses.dataclass(frozen=True)
class SamConfig:
    backbone: BackboneConfig = L2
    neck_depth: int = 12
    image_size: int = 512  # EfficientViT-SAM runs at 512 (reference sam.py:214)
    prompt_input_size: int = 1024
    norm_eps: float = 1e-6  # every SAM norm (reference sam_model_zoo.py:44 set_norm_eps)


SAM_L0 = SamConfig(backbone=L0, neck_depth=4)
SAM_L1 = SamConfig(backbone=L1, neck_depth=8)
SAM_L2 = SamConfig(backbone=L2, neck_depth=12)

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


class EfficientViTSam:
    """Encode once, decode cheaply per prompt or head.

    params: {'image_encoder', 'prompt_encoder', 'mask_decoder'}. ``image``:
    (B, 3, S, S) at the config's image size, SAM-normalised
    (:func:`preprocess_sam_image`); points in the 1024 prompt frame."""

    def __init__(self, cfg: SamConfig = SAM_L2, dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    def encode_image(self, p, image: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return sam_image_encoder(sub(p, "image_encoder"), image, cfg.backbone, cfg.neck_depth,
                                 cfg.norm_eps, self.dtype)

    def decode(self, p, embedding, points, labels, multimask_output: bool = True):
        pe_p = sub(p, "prompt_encoder")
        sparse, dense_prompt = prompt_encoder(pe_p, points, labels, self.cfg.prompt_input_size)
        return mask_decoder(sub(p, "mask_decoder"), embedding, dense_pe(pe_p, embedding.device),
                            sparse, dense_prompt, multimask_output, norm_eps=self.cfg.norm_eps)

    def __call__(self, p, image, points, labels, multimask_output: bool = True):
        return self.decode(p, self.encode_image(p, image), points, labels, multimask_output)

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random init in the JAX tree layout, drawn from ``generator`` on its
        device; every leaf fp32 (the JAX app keeps SAM's params fp32 and
        computes the encoder in its dtype)."""
        meta = torch.device("meta")
        s = self.cfg.image_size
        tree = InitTree()
        emb = self.encode_image(tree, torch.zeros((1, 3, s, s), device=meta))
        self.decode(tree, emb, torch.zeros((1, 2, 2), device=meta),
                    torch.zeros((1, 2), dtype=torch.long, device=meta))
        return materialize(tree, generator, torch.float32)


def preprocess_sam_image(img01: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] (already 512 and padded) -> SAM-normalised."""
    mean = torch.tensor(SAM_PIXEL_MEAN, dtype=torch.float32, device=img01.device) / 255.0
    std = torch.tensor(SAM_PIXEL_STD, dtype=torch.float32, device=img01.device) / 255.0
    return (img01 - mean[:, None, None]) / std[:, None, None]


def postprocess_masks(masks: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, M, 256, 256) logits -> (B, M, *out_hw), jax.image.resize's
    bilinear (ops/resize.py::linear_resize)."""
    return linear_resize(masks, out_hw)


# --------------------------------------------------------------------------
# Upstream EfficientViT-SAM state dicts (han-cai l0/l1/l2 and the four
# finetuned EdgeStyle decoders) -> the port's tree. Torch's layouts are the
# port's (conv OIHW, linear (out, in), conv-transpose (in, out, kH, kW)), so
# the mapping renames: OpSequential ``op_list``, ResidualBlock ``main``,
# DAGBlock ``input_ops``/``middle``/``output_ops``.
# --------------------------------------------------------------------------
def _bn(rules, tp, fp):
    rules += [(tp + r"\.weight", fp + ".scale"), (tp + r"\.bias", fp + ".bias"),
              (tp + r"\.running_mean", fp + ".mean"), (tp + r"\.running_var", fp + ".var"),
              (tp + r"\.num_batches_tracked", None)]


def _weight_bias(rules, tp, fp, weight="kernel"):
    rules += [(tp + r"\.weight", f"{fp}.{weight}"), (tp + r"\.bias", fp + ".bias")]


def _conv_layer(rules, tp, fp, norm=True):
    _weight_bias(rules, tp + r"\.conv", fp + ".conv")
    if norm:
        _bn(rules, tp + r"\.norm", fp + ".norm")


def _mb(rules, tp, fp, norms):
    for name, norm in zip(("inverted_conv", "depth_conv", "point_conv"), norms):
        _conv_layer(rules, tp + rf"\.{name}", f"{fp}.{name}", norm)


def _backbone_rules(rules, depth_list):
    d = depth_list
    B, bo = r"image_encoder\.backbone\.stages", "image_encoder.backbone"
    _conv_layer(rules, B + r"\.0\.op_list\.0", f"{bo}.stage0_stem")
    for j in range(d[0]):
        for c in ("conv1", "conv2"):
            _conv_layer(rules, B + rf"\.0\.op_list\.{j + 1}\.main\.{c}",
                        f"{bo}.stage0_block_{j}.{c}")
    for sid in (1, 2, 3):
        for j in range(d[sid] + 1):
            tp, fp = B + rf"\.{sid}\.op_list\.{j}\.main", f"{bo}.stage{sid}_block_{j}"
            if sid <= 2:
                for c in ("spatial_conv", "point_conv"):
                    _conv_layer(rules, tp + rf"\.{c}", f"{fp}.{c}")
            else:  # MBConv with fewer norms
                _mb(rules, tp, fp, (False, False, True))
    _mb(rules, B + r"\.4\.op_list\.0\.main", f"{bo}.stage4_block_0", (False, False, True))
    for j in range(d[4]):
        tp, fp = B + rf"\.4\.op_list\.{j + 1}", f"{bo}.stage4_vit_{j}"
        cm, cf = tp + r"\.context_module\.main", fp + ".context_module"
        _conv_layer(rules, cm + r"\.qkv", cf + ".qkv", norm=False)
        rules += [(cm + r"\.aggreg\.0\.0\.weight", cf + ".aggreg_0_depth.kernel"),
                  (cm + r"\.aggreg\.0\.1\.weight", cf + ".aggreg_0_point.kernel")]
        _conv_layer(rules, cm + r"\.proj", cf + ".proj")
        _mb(rules, tp + r"\.local_module\.main", fp + ".local_module", (False, False, True))


def _sam_rules(cfg: SamConfig):
    rules = []
    _backbone_rules(rules, cfg.backbone.depth_list)
    ne = "image_encoder.neck"
    for i, fid in enumerate(("stage4", "stage3", "stage2")):
        _conv_layer(rules, rf"image_encoder\.neck\.input_ops\.{i}\.op_list\.0", f"{ne}.input_{fid}")
    for j in range(cfg.neck_depth):
        for c in ("spatial_conv", "point_conv"):
            _conv_layer(rules, rf"image_encoder\.neck\.middle\.op_list\.{j}\.main\.{c}",
                        f"{ne}.middle_{j}.{c}")
    _conv_layer(rules, r"image_encoder\.neck\.output_ops\.0\.op_list\.0",
                f"{ne}.output_sam_encoder", norm=False)
    _weight_bias(rules, r"image_encoder\.norm", "image_encoder.norm", "scale")

    pe = "prompt_encoder"
    rules += [(r"prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix",
               f"{pe}.pe_gaussian"),
              (r"prompt_encoder\.(point_embeddings\.\d)\.weight", pe + r".\1"),
              (r"prompt_encoder\.not_a_point_embed\.weight", f"{pe}.not_a_point_embed"),
              (r"prompt_encoder\.no_mask_embed\.weight", f"{pe}.no_mask_embed"),
              (r"prompt_encoder\.mask_downscaling\..*", None)]

    md, fo = r"mask_decoder", "mask_decoder"
    rules += [(md + r"\.iou_token\.weight", fo + ".iou_token"),
              (md + r"\.mask_tokens\.weight", fo + ".mask_tokens")]
    attns = ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token")
    for i in range(2):
        tp, fp = md + rf"\.transformer\.layers\.{i}", f"{fo}.transformer.layers_{i}"
        for a in attns:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _weight_bias(rules, tp + rf"\.{a}\.{proj}", f"{fp}.{a}.{proj}")
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _weight_bias(rules, tp + rf"\.{n}", f"{fp}.{n}", "scale")
        _weight_bias(rules, tp + r"\.mlp\.lin1", fp + ".mlp_lin1")
        _weight_bias(rules, tp + r"\.mlp\.lin2", fp + ".mlp_lin2")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _weight_bias(rules, md + rf"\.transformer\.final_attn_token_to_image\.{proj}",
                     f"{fo}.transformer.final_attn_token_to_image.{proj}")
    _weight_bias(rules, md + r"\.transformer\.norm_final_attn",
                 fo + ".transformer.norm_final_attn", "scale")
    _weight_bias(rules, md + r"\.output_upscaling\.0", fo + ".upscale_conv1")
    _weight_bias(rules, md + r"\.output_upscaling\.1", fo + ".upscale_norm", "scale")
    _weight_bias(rules, md + r"\.output_upscaling\.3", fo + ".upscale_conv2")
    for i in range(4):
        for j in range(3):
            _weight_bias(rules, md + rf"\.output_hypernetworks_mlps\.{i}\.layers\.{j}",
                         f"{fo}.hyper_mlps_{i}.layers_{j}")
    for j in range(3):
        _weight_bias(rules, md + rf"\.iou_prediction_head\.layers\.{j}", f"{fo}.iou_mlp.layers_{j}")
    return [(re.compile(pat), tmpl) for pat, tmpl in rules]


def port_sam_state_dict(sd, cfg: SamConfig = SAM_L2) -> Dict[str, np.ndarray]:
    """An upstream EfficientViTSam state dict (``image_encoder.backbone.
    stages.{s}.op_list.{j}...``, ``prompt_encoder...``, ``mask_decoder...``;
    numpy arrays or tensors) -> flat {dotted path: numpy array} of the
    port's tree (core/porting.py::tree_from_flat places it). Every key must
    match a rule; the prompt encoder's four point embeddings become one
    (4, 256) table, its not-a-point and no-mask embeddings vectors."""
    from edgestyle_tpu_torch.core.porting import rename_keys

    out = rename_keys(sd, _sam_rules(cfg))
    pe = "prompt_encoder"
    pts = [out.pop(f"{pe}.point_embeddings.{i}") for i in range(4)
           if f"{pe}.point_embeddings.{i}" in out]
    if pts:
        out[f"{pe}.point_embeddings"] = np.concatenate(pts, axis=0)
    for name in ("not_a_point_embed", "no_mask_embed"):
        if f"{pe}.{name}" in out:
            out[f"{pe}.{name}"] = out[f"{pe}.{name}"][0]
    return out

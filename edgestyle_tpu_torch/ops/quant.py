"""Opt-in W8A8 int8 serving of the denoise step.

Counterpart of edgestyle_tpu/ops/quant.py, with its semantics:

  - weights: symmetric per-output-channel int8, ``s = absmax / 127``
    (at least 1e-12), ``q = round(w / s)``, quantised into
    :class:`QuantKernel` leaves (:func:`quantize_denoise_params`) once for
    a set of weights, which the pipeline keeps while they are unchanged;
  - activations: symmetric per-tensor int8, dynamic (``"int8"``: the scale
    is the tensor's absmax / 127, no clip) or static (``"int8-static"``: a
    per-layer scale from a calibration table, clipped to +-127);
  - the product in int32, dequantised as ``y_i32 * (sx * sw) + bias`` in
    fp32, then cast to the layer's type.

Both divide (``x / s``), never multiply by ``1 / s``, and round half to
even (``torch.round``), so q and s agree with JAX's bit for bit. A divisor
is always a tensor on the data's device: CUDA's ``div`` turns a Python
scalar divisor into a multiply by its reciprocal, which can differ by one
ulp. Dynamic scales stay on the device (no host sync per layer).

Two routes for the int8 product, by the device of the data:

  - the card: ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32 GEMM; the JAX
    package leaves its int8 product to XLA outside any Pallas kernel). A 3x3
    conv is an im2col GEMM: ``torch.cat`` of the kh*kw shifted slices of the
    zero-padded NHWC int8 activation, in (kh, kw, cin) order, times the
    (kh*kw*Cin, Cout) weight matrix, which is the OIHW kernel in
    ``channels_last`` memory read as (Cout, kh*kw*Cin). ``F.unfold`` has no
    int8 kernel. ``torch._int_mm`` needs more than 16 rows and inner and
    output sizes that are multiples of 8: a shape outside raises, it never
    falls back;
  - the plain version (CPU tensors): the same product in fp64 (``F.conv2d``
    / ``matmul`` of the int8 values as doubles), rounded to int32. It is
    exact: |sum| <= 127^2 * 9 * 2560 < 2^53 (fp32 would not be, > 2^24).

The layers (models/layers.py ``dense`` / ``conv`` / ``pointwise`` and
ops/fused_conv.py ``norm_act_conv3x3``) dispatch as JAX's ``_interceptor``:
a :class:`QuantKernel` leaf goes int8; inside an active
:func:`quantize_intercept` scope a plain kernel goes int8 dynamically when
:func:`conv_quantizable` / :func:`dense_quantizable` holds. That includes
the ControlNet zero-conv heads: ``quantize_params`` skips them by name, so
they stay plain leaves, but they are 1x1 convs with Cin, Cout >= 64 and so
run int8 dynamically even under ``int8-static`` (without a key, never
recorded), as JAX's interceptor does whatever its docstring says.

Under tensor parallelism (ops/tp.py, ``generate_tp``) the weights are
quantised whole and then sliced (core/partitioning.py::local_shard), and a
row-parallel Dense, whose input and kernel hold this rank's share of the
features, runs :func:`quant_dense_row_parallel`: the activation's absmax
and, for a plain kernel, each row's absmax are maxed over the model group
before the scales are taken, the int32 accumulators are summed over it
(exact) and dequantised once. Every scale, accumulator and count is then
the single process's.

Scales and recording are module-level state, as in JAX: all device work of
a generation runs on one thread. ``COUNTS`` counts the int8 products by
kind, where they are computed, so a caller can see that a run quantised.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.ops import tp

# ops smaller than this do not earn their requant overhead and carry most
# of the numeric risk (zero-conv heads of small configs, time MLPs)
MIN_QUANT_CHANNELS = 64

COUNTS: Dict[str, int] = {"conv": 0, "dense": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s as a true division: s (a tensor or a float) as an fp32 tensor
    on x's device."""
    if not isinstance(s, torch.Tensor):
        s = torch.full((), float(s), dtype=torch.float32, device=x.device)
    return x / s


def quantize_weight(w: torch.Tensor, contract_dims: Tuple[int, ...], sharded: bool = False):
    """Symmetric per-output-channel int8: ``contract_dims`` are the dims the
    product reduces over (all but the output-feature dim). Returns (q int8
    in w's layout and memory format, s fp32 with w's rank, keepdim). With
    ``sharded`` ``w`` holds this rank's share of the contracted dims and
    each row's absmax is the max over the model group: the full kernel's."""
    w32 = w.float()
    absmax = torch.amax(w32.abs(), dim=contract_dims, keepdim=True)
    if sharded:
        absmax = tp.max_over_model(absmax)
    s = torch.clamp_min(_div(absmax, 127.0), 1e-12)
    return torch.round(w32 / s).to(torch.int8), s


def quantize_activation(x: torch.Tensor, sharded: bool = False):
    """Symmetric per-tensor dynamic int8: (q, 0-d fp32 scale on x's device).
    With ``sharded`` ``x`` is this rank's share and the absmax is the max
    over the model group: the whole tensor's."""
    x32 = x.float()
    absmax = x32.abs().amax()
    if sharded:
        absmax = tp.max_over_model(absmax)
    s = torch.clamp_min(_div(absmax, 127.0), 1e-12)
    return torch.round(x32 / s).to(torch.int8), s


# ------------------------------------------------- activation scale modes
_STATIC_SCALES: Optional[Dict[str, float]] = None  # {key: float} table
# the last installed table and its scales as 0-d fp32 tensors by (key, device)
_STATIC_ON_DEVICE: tuple = (None, {})
_RECORDER: Optional[Dict[str, torch.Tensor]] = None  # calibration collection
_ACTIVE = False  # inside quantize_intercept


@contextlib.contextmanager
def recording(rec: dict):
    """Collect dynamic activation scales per layer key: inside the block every
    keyed activation runs the dynamic path (whatever static table is
    installed) and max-accumulates its 0-d device scale into ``rec``."""
    global _RECORDER
    old = _RECORDER
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = old


def _static_scale(key: str, device: torch.device) -> torch.Tensor:
    """The installed table's scale for ``key`` as a 0-d fp32 tensor on
    ``device`` (the float rounded to fp32 once, as JAX's weakly typed
    constant), made once per table, key and device."""
    global _STATIC_ON_DEVICE
    if _STATIC_ON_DEVICE[0] is not _STATIC_SCALES:
        _STATIC_ON_DEVICE = (_STATIC_SCALES, {})
    made = _STATIC_ON_DEVICE[1]
    s = made.get((key, device))
    if s is None:
        s = torch.full((), float(_STATIC_SCALES[key]), dtype=torch.float32, device=device)
        if type(s) is torch.Tensor:  # not a tracer's tensor (an export's), which dies with it
            made[(key, device)] = s
    return s


def activation_to_int8(x: torch.Tensor, key: Optional[str] = None, sharded: bool = False):
    """Quantise an activation in the current mode: recording -> dynamic and
    collected; a static table hit -> that scale, clipped to +-127;
    otherwise dynamic. ``sharded``: :func:`quantize_activation`'s."""
    if _RECORDER is not None and key is not None:
        q, s = quantize_activation(x, sharded)
        prev = _RECORDER.get(key)
        _RECORDER[key] = s if prev is None else torch.maximum(prev, s)
        return q, s
    if _STATIC_SCALES is not None and key is not None and key in _STATIC_SCALES:
        s = _static_scale(key, x.device)
        q = torch.clamp(torch.round(x.float() / s), -127.0, 127.0).to(torch.int8)
        return q, s
    return quantize_activation(x, sharded)


@contextlib.contextmanager
def quantize_intercept(enable: bool = True, static_scales: Optional[Dict[str, float]] = None):
    """Run every large conv / Dense inside as W8A8 int8 (the layers' gates),
    with the calibrated ``static_scales`` table ({layer key: float}) where
    given, dynamic scales otherwise."""
    global _STATIC_SCALES, _ACTIVE
    if not enable:
        yield
        return
    old = (_STATIC_SCALES, _ACTIVE)
    _STATIC_SCALES, _ACTIVE = static_scales, True
    try:
        yield
    finally:
        _STATIC_SCALES, _ACTIVE = old


def active() -> bool:
    return _ACTIVE


# ------------------------------------------------------------- prequant
class QuantKernel:
    """A pre-quantised kernel: int8 ``q`` in the port's layout (OIHW in
    ``channels_last`` memory for a conv, (out, in) for a Dense), its fp32
    per-output-channel scale ``s`` (out,), and ``key``, the layer's
    ``prefix/path/.../kernel`` in the param tree (the static table's key)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, key: str = ""):
        self.q = q
        self.s = s
        self.key = key

    def matrix(self) -> torch.Tensor:
        """(out, K) int8, K in (kh, kw, cin) order for a conv: a view of q."""
        q = self.q
        return q.permute(0, 2, 3, 1).reshape(q.shape[0], -1) if q.ndim == 4 else q


def is_prequant(kernel) -> bool:
    return isinstance(kernel, QuantKernel)


# Skipped by name, as in JAX: the time embeddings run on (B, C) vectors and
# are latency-trivial; the ControlNet zero-conv heads stay plain leaves.
_SKIP_NAME_PARTS = ("time_embedding", "time_emb_proj", "controlnet_")


def quantize_params(tree, prefix: str = ""):
    """Pre-quantise every large conv / Dense kernel of a param tree: a conv
    kernel (4-D) with Cin and Cout >= MIN_QUANT_CHANNELS and a Dense kernel
    (2-D) with both sizes >= it become :class:`QuantKernel` leaves keyed
    ``prefix/path/kernel``; every other leaf passes through. ``prefix``
    keeps the tied ControlLoRA trunks' keys apart from the UNet's."""

    def walk(sub, path):
        if isinstance(sub, dict):
            return {k: walk(v, path + (k,)) for k, v in sub.items()}
        leaf = sub
        if path and path[-1] == "kernel" and isinstance(leaf, torch.Tensor):
            if any(p in part for p in _SKIP_NAME_PARTS for part in path):
                return leaf
            key = "/".join(((prefix,) if prefix else ()) + path)
            if leaf.ndim == 4 and min(leaf.shape[0], leaf.shape[1]) >= MIN_QUANT_CHANNELS:
                q, s = quantize_weight(leaf, (1, 2, 3))
                return QuantKernel(q, s.reshape(-1), key)
            if leaf.ndim == 2 and min(leaf.shape) >= MIN_QUANT_CHANNELS:
                q, s = quantize_weight(leaf, (1,))
                return QuantKernel(q, s.reshape(-1), key)
        return leaf

    return walk(tree, ())


def quantize_denoise_params(params):
    """The quantised scope of the denoise step: the UNet and every ControlNet
    branch tree (the static net and the ControlLoRAs), each under its own
    key prefix; the fusion blocks, VAE and CLIP stay as they are. Used alike
    by generation and calibration, so a static table matches the layers
    that serve."""
    cn = {k: quantize_params(v, prefix=k) if k.startswith("lora_") or k == "static" else v
          for k, v in params["controlnet"].items()}
    return {**params, "unet": quantize_params(params["unet"], prefix="unet"), "controlnet": cn}


# -------------------------------------------------------- int8 products
def int_mm(a: torch.Tensor, w: torch.Tensor, what: str = "int8 GEMM") -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32 on cuBLASLt (``torch._int_mm``,
    B as the transpose of the row-major weight). Its limits (more than 16
    rows, K and N multiples of 8) raise here, naming the layer."""
    (m, k), n = a.shape, w.shape[0]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"{what}: the int8 GEMM needs M > 16 and K, N multiples of 8, got "
                         f"M={m}, K={k}, N={n}")
    return torch._int_mm(a.contiguous(), w.contiguous().t())


def int_mm_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int_mm`: the fp64 product, exact, as int32."""
    return torch.round(a.double() @ w.double().t()).to(torch.int32)


def _pads(padding) -> Tuple[int, int, int, int]:
    """int or (top, bottom, left, right) -> (top, bottom, left, right)."""
    if isinstance(padding, int):
        return (padding,) * 4
    return tuple(int(p) for p in padding)


def im2col(qx: torch.Tensor, kh: int, kw: int, stride: int, padding):
    """(B, Cin, H, W) int8 (channels_last) -> ((B*Ho*Wo, kh*kw*Cin) int8 in
    (kh, kw, cin) order, Ho, Wo): the zero-padded NHWC image's kh*kw shifted
    (strided) slices side by side."""
    top, bottom, left, right = _pads(padding)
    x = qx.permute(0, 2, 3, 1)
    b, h, w, c = x.shape
    if top or bottom or left or right:
        xp = x.new_zeros((b, h + top + bottom, w + left + right, c))
        xp[:, top:top + h, left:left + w] = x
        x = xp
    ho = (x.shape[1] - kh) // stride + 1
    wo = (x.shape[2] - kw) // stride + 1
    taps = [x[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(b * ho * wo, kh * kw * c), ho, wo


def conv_int32(qx: torch.Tensor, kernel: QuantKernel, stride: int = 1, padding=0) -> torch.Tensor:
    """The int8 conv's int32 accumulator, NHWC (B, Ho, Wo, Cout): the im2col
    GEMM on ``torch._int_mm`` for CUDA tensors, the plain version for CPU
    tensors."""
    if qx.is_cuda:
        kh, kw = kernel.q.shape[2:]
        cols, ho, wo = im2col(qx, kh, kw, stride, padding)
        acc = int_mm(cols, kernel.matrix(), f"int8 conv {tuple(qx.shape)} -> {kernel.q.shape[0]}")
        return acc.reshape(qx.shape[0], ho, wo, -1)
    return conv_int32_reference(qx, kernel.q, stride, padding)


def conv_int32_reference(qx: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                         padding=0) -> torch.Tensor:
    """Plain version of :func:`conv_int32`: the conv of the int8 values in
    fp64 (exact), rounded to int32, NHWC."""
    top, bottom, left, right = _pads(padding)
    x = F.pad(qx.double(), (left, right, top, bottom))
    out = F.conv2d(x, qw.double(), stride=stride)
    return torch.round(out).to(torch.int32).permute(0, 2, 3, 1)


def dense_int32(qx: torch.Tensor, kernel: QuantKernel) -> torch.Tensor:
    """(..., in) int8 -> (..., out) int32: ``torch._int_mm`` for CUDA tensors,
    the plain version for CPU tensors."""
    a = qx.reshape(-1, qx.shape[-1])
    w = kernel.matrix()
    if qx.is_cuda:
        acc = int_mm(a, w, f"int8 dense {tuple(qx.shape)} -> {w.shape[0]}")
    else:
        acc = int_mm_reference(a, w)
    return acc.reshape(*qx.shape[:-1], -1)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 (..., out) -> ``acc * (sx * sw) + bias`` in fp32, cast to dtype."""
    y = acc.float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _as_quant(kernel) -> QuantKernel:
    """A :class:`QuantKernel` as it is, a plain kernel quantised per output
    channel (dim 0 of OIHW and of (out, in)), without a key."""
    if is_prequant(kernel):
        return kernel
    q, s = quantize_weight(kernel, tuple(range(1, kernel.ndim)))
    return QuantKernel(q, s.reshape(-1))


def quant_conv(x: torch.Tensor, kernel, bias: Optional[torch.Tensor], dtype: torch.dtype,
               stride: int = 1, padding=0) -> torch.Tensor:
    """int8 conv of NCHW x with an OIHW kernel (a :class:`QuantKernel`, or a
    plain one quantised here), optional stride, symmetric or (top, bottom,
    left, right) padding -> NCHW (channels_last) in dtype."""
    qk = _as_quant(kernel)
    qx, sx = activation_to_int8(x, qk.key or None)
    acc = conv_int32(qx, qk, stride, padding)
    COUNTS["conv"] += 1
    return dequantize(acc, sx, qk.s, bias, dtype).permute(0, 3, 1, 2)


def quant_dense(x: torch.Tensor, kernel, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """int8 Dense of (..., in) x with an (out, in) kernel, or an OIHW 1x1 conv
    kernel on tokens (a :class:`QuantKernel`, or a plain one quantised here)
    -> (..., out)."""
    qk = _as_quant(kernel)
    qx, sx = activation_to_int8(x, qk.key or None)
    acc = dense_int32(qx, qk)
    COUNTS["dense"] += 1
    return dequantize(acc, sx, qk.s, bias, dtype)


def quant_dense_row_parallel(x: torch.Tensor, kernel, bias: Optional[torch.Tensor],
                             dtype: torch.dtype) -> torch.Tensor:
    """int8 row-parallel Dense inside ``tp.model_parallel``: ``x`` (..., in/tp)
    holds this rank's share of the features and ``kernel`` the matching
    columns (a sliced :class:`QuantKernel` keeps the full kernel's scales;
    a plain shard is quantised with its rows' absmax maxed over the model
    group). The activation scale is the whole tensor's (its absmax maxed
    over the group, or the static table's), the int32 accumulators of the
    shards are summed over the group, exactly, and dequantised once with
    the bias: the single process's int8 Dense, bit for bit."""
    if is_prequant(kernel):
        qk = kernel
    else:
        q, s = quantize_weight(kernel, (1,), sharded=True)
        qk = QuantKernel(q, s.reshape(-1))
    qx, sx = activation_to_int8(x, qk.key or None, sharded=True)
    acc = tp.sum_from_model(dense_int32(qx, qk))
    COUNTS["dense"] += 1
    return dequantize(acc, sx, qk.s, bias, dtype)


def dequantized_dense(x: torch.Tensor, kernel: QuantKernel, bias: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """A pre-quantised Dense on a (B, C) vector batch: the exact fp32 product
    with the dequantised kernel (JAX's safety net; the name skips keep the
    time embeddings, the only such inputs, plain)."""
    y = x.float() @ (kernel.q.float() * kernel.s[:, None]).t()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def conv_quantizable(x: torch.Tensor, features: int) -> bool:
    """JAX's ``_conv_quantizable`` for the port's convs (no groups or
    dilation): a 4-D input with Cin and Cout >= MIN_QUANT_CHANNELS. No
    rule of core/partitioning.py splits a conv, so Cin is the global
    width under tensor parallelism too."""
    return x.ndim == 4 and min(x.shape[1], features) >= MIN_QUANT_CHANNELS


def dense_quantizable(x: torch.Tensor, features: int, in_features: Optional[int] = None) -> bool:
    """JAX's ``_dense_quantizable``: token or spatial matmuls only ((B, C)
    vectors are latency-trivial and precision-sensitive). ``in_features``:
    the global input width where ``x`` holds a share of it (a row-parallel
    Dense), as GSPMD's program sees the layer; default ``x.shape[-1]``."""
    width = x.shape[-1] if in_features is None else in_features
    return (x.ndim >= 3 and min(width, features) >= MIN_QUANT_CHANNELS
            and x.shape[-2] >= 64)

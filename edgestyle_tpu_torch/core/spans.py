"""Named ranges ("spans") at the layer boundaries of a try-on request and
of a training step.

Under ``torch.profiler`` a span is a range of the host's trace, recorded
as an operator (``RecordFunctionFast``: not a user annotation, so kineto
makes no device copy of it and a trace's device operations stay the
kernels, copies and sets alone), in the same trace, and on the same clock,
as the device's activity: each device operation, and each idle gap, can be
put down to the span the host was in when it was launched. Under
``torch.autograd.profiler.emit_nvtx()`` the same ranges are NVTX ranges.
Outside a profiler :func:`span` returns one shared no-op context after a
flag check: no torch call, so ``torch.export`` and a dispatch mode see no
new operator. A span never synchronises, reads a tensor or changes a
result.

``python3 -m portbench.spans`` reduces them to calls, host ms, device ms
and idle ms an item (``portbench/spans.py``). The spans:

- ``edgestyle/gen``: ``EdgeStylePipeline.__call__``, the root of a request;
- ``edgestyle/clip``: ``CLIPTextEncoder.__call__``;
- ``edgestyle/vae.encode``: ``AutoencoderKL.encode_moments``, the one
  encoder entry;
- ``edgestyle/vae.decode``: ``AutoencoderKL.decode``;
- ``edgestyle/mcn``: ``EdgeStyleMultiControlNet.__call__``, the trunks,
  the residual scaling and the fusion;
- ``edgestyle/mcn.fusion``: its ``edgestyle_fusion``;
- ``edgestyle/unet``: ``SD15UNet.__call__`` and ``shallow_forward``, not
  ``controlnet_forward``;
- ``edgestyle/train.step``: ``make_train_step``'s step, the root of a step;
- ``edgestyle/train.merge_lora``: the two ``controllora_params`` of a
  micro-batch's loss;
- ``edgestyle/train.backward``: a micro-batch's ``torch.autograd.grad``;
- ``edgestyle/train.accumulate``: the gradient accumulator's update;
- ``edgestyle/train.optimizer``: the clipping, Prodigy and
  ``apply_updates``.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

GEN = "edgestyle/gen"
CLIP = "edgestyle/clip"
VAE_ENCODE = "edgestyle/vae.encode"
VAE_DECODE = "edgestyle/vae.decode"
MCN = "edgestyle/mcn"
MCN_FUSION = "edgestyle/mcn.fusion"
UNET = "edgestyle/unet"
TRAIN_STEP = "edgestyle/train.step"
TRAIN_MERGE_LORA = "edgestyle/train.merge_lora"
TRAIN_BACKWARD = "edgestyle/train.backward"
TRAIN_ACCUMULATE = "edgestyle/train.accumulate"
TRAIN_OPTIMIZER = "edgestyle/train.optimizer"

_OFF = contextlib.nullcontext()


def span(name: str):
    """An operator range ``name`` while a profiler runs, else a shared no-op
    context (the profiler's own Python flag, read per call)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)

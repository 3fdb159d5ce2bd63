"""Deployment export: ``torch.export`` programs with numeric parity asserts.

Counterpart of edgestyle_tpu/core/export.py, which serialises the jitted
program with ``jax.export``. Here the artifact is a ``torch.export``
program (``*.pt2``): the function traced to ATen operators, with the port's
kernels as single ``edgestyle::*`` operator nodes (ops/library.py), so a
reloaded program launches the same kernels on the card as the live code.
The parameters are an argument of the program, as in JAX's, so the file
holds no weights; :func:`export_program` drops the example inputs that
``torch.export`` would otherwise save beside the graph.

Each export reloads the file and asserts parity on the example inputs
with the JAX package's semantics: ``rtol`` / ``atol`` elementwise, or, with
``max_violation_frac``, at most that share of elements outside them, where
a non-finite difference always counts as outside.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn`` over its arguments."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class LoadedProgram:
    """A reloaded program: ``call(*args)`` runs it (under ``no_grad``) and
    returns its outputs; ``in_meta`` / ``out_meta`` hold each flat input's
    and output's (shape, dtype) in the order of ``torch.export``'s
    flattening of the arguments and the result, and :meth:`arg_meta` those
    of one positional argument."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self.module = program.module()
        metas = {n.name: n.meta.get("val") for n in program.graph.nodes}
        sig = program.graph_signature
        self.in_meta = [_meta(metas[s.arg.name]) for s in sig.input_specs
                        if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
        out_node = program.graph.output_node()
        self.out_meta = [_meta(a.meta.get("val")) for a in pytree.tree_leaves(out_node.args[0])]
        self.in_spec = _children(program.call_spec.in_spec)[0]
        # torch's own input check walks every leaf's key path, ~40 us a leaf
        # on the host, each call (0.1 s a denoise step at SD1.5 width, where
        # the graph takes ~2,400 params): :meth:`call` checks the same
        # structure, shapes and types from a plain flatten instead
        hooks = self.module._forward_pre_hooks
        for key in [k for k, h in hooks.items()
                    if getattr(h, "__name__", "") == "_check_input_constraints_pre_hook"]:
            del hooks[key]

    def arg_meta(self, index: int):
        """The (shape, dtype) of each leaf of positional argument ``index``."""
        counts = [c.num_leaves for c in _children(self.in_spec)]
        start = sum(counts[:index])
        return self.in_meta[start:start + counts[index]]

    @torch.no_grad()
    def call(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if spec != self.in_spec:
            raise ValueError(f"the program takes arguments shaped as {self.in_spec}, got {spec}")
        for i, (leaf, (shape, dtype)) in enumerate(zip(leaves, self.in_meta)):
            if isinstance(leaf, torch.Tensor) and (tuple(leaf.shape) != shape
                                                   or leaf.dtype != dtype):
                raise ValueError(f"input {i} of the program is {shape} {dtype}, got "
                                 f"{tuple(leaf.shape)} {leaf.dtype}")
        return self.module(*args)


def _children(spec):
    """A pytree spec's child specs (``children()`` in newer torch releases,
    the ``children_specs`` field in older ones)."""
    return spec.children() if callable(getattr(spec, "children", None)) else spec.children_specs


def _meta(val):
    return (tuple(val.shape), val.dtype) if isinstance(val, torch.Tensor) else (None, type(val))


def _register_ops() -> None:
    """Import the modules that define the ``edgestyle::*`` operators, so a
    graph that names them can be loaded."""
    from edgestyle_tpu_torch.ops import flash, fused_conv  # noqa: F401


def parity_violations(ref: torch.Tensor, out: torch.Tensor, rtol: float, atol: float):
    """(share of elements outside ``atol + rtol * |ref|``, counting every
    non-finite difference, and the largest absolute difference)."""
    a = ref.detach().float().cpu().numpy()
    b = out.detach().float().cpu().numpy()
    diff = np.abs(a - b)
    bad = ~np.isfinite(diff) | (diff > (atol + rtol * np.abs(a)))
    return float(bad.mean()) if bad.size else 0.0, float(diff.max()) if diff.size else 0.0


def unaliased(args):
    """``args`` with every tensor that shares storage with an earlier one
    copied. ``torch.export`` traces two aliased inputs as one placeholder,
    so a graph traced on the pipeline's params (the ControlLoRA branches
    share the UNet's trunk tensors, the branches their heads at init) would
    read one leaf for both wherever a caller passes them apart."""
    seen = set()

    def fresh(t: torch.Tensor) -> torch.Tensor:
        key = (t.device, t.untyped_storage().data_ptr())
        if key in seen:
            return t.clone()
        seen.add(key)
        return t

    return pytree.tree_map_only(torch.Tensor, fresh, args)


def export_program(fn: Callable, example_args: Sequence[Any], path: str,
                   rtol: float = 1e-3, atol: float = 1e-5,
                   max_violation_frac: float = 0.0) -> Dict[str, float]:
    """Export ``fn`` traced on ``example_args`` to ``path`` (``*.pt2``),
    reload it and assert numeric parity with ``fn`` on the same inputs
    (the JAX package's semantics, see the module docstring). Tensors that
    the arguments share are traced as separate inputs (:func:`unaliased`).
    Returns the
    seconds of each part (``trace_s``, ``save_s``, ``load_s``), the file's
    ``bytes``, the graph's ``nodes`` and the measured ``violation_frac`` and
    ``max_abs_diff``."""
    _register_ops()
    args = unaliased(tuple(example_args))
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(_Program(fn), args, strict=False)
    t1 = time.perf_counter()
    program._example_inputs = None  # the parameters are inputs: keep them out of the file
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    t2 = time.perf_counter()
    reloaded = load_program(path)
    t3 = time.perf_counter()
    with torch.no_grad():
        ref = pytree.tree_leaves(fn(*args))
    out = pytree.tree_leaves(reloaded.call(*args))
    if len(ref) != len(out):
        raise AssertionError(f"export parity: {len(out)} outputs reloaded, {len(ref)} live")
    worst_frac, worst_diff = 0.0, 0.0
    for a, b in zip(ref, out):
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"export parity: shape {tuple(b.shape)} vs {tuple(a.shape)}")
        frac, diff = parity_violations(a, b, rtol, atol)
        if frac > max_violation_frac:
            raise AssertionError(
                f"export parity: {frac:.2%} of elements outside (rtol={rtol}, atol={atol}) > "
                f"allowed {max_violation_frac:.2%}; max abs diff {diff:.4g}")
        worst_frac, worst_diff = max(worst_frac, frac), max(worst_diff, diff)
    return {"trace_s": t1 - t0, "save_s": t2 - t1, "load_s": t3 - t2,
            "bytes": os.path.getsize(path), "nodes": len(program.graph.nodes),
            "violation_frac": worst_frac, "max_abs_diff": worst_diff}


def load_program(path: str) -> LoadedProgram:
    """Reload a program that :func:`export_program` wrote; returns an
    object with ``.call(*args)``."""
    _register_ops()
    return LoadedProgram(torch.export.load(path))


def flop_report(fn: Callable, *example_args) -> Dict[str, Any]:
    """The FLOPs of one call of ``fn``, counted by ``FlopCounterMode`` on
    fake copies of the arguments: no device time. The port's kernels count
    through their operators' formulas (ops/library.py); elementwise work is
    not counted. Returns ``{"flops": total, "by_operator": {name: flops}}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    _register_ops()
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = pytree.tree_map_only(torch.Tensor, mode.from_tensor, tuple(example_args))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), mode, counter:
        fn(*fake)
    by_op = {str(k): int(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_operator": by_op}

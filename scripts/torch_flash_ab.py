"""Time one of the port's flash kernels against another build of it, in turns
on one card (PyTorch/CUDA port, ``edgestyle_tpu_torch``).

    mkdir -p build/torch_ext/parent
    git archive <commit> | tar -x -C build/torch_ext/parent
    python3 scripts/torch_flash_ab.py build/torch_ext/parent               # the forward
    python3 scripts/torch_flash_ab.py build/torch_ext/parent --kernel dq   # dq backward
    python3 scripts/torch_flash_ab.py build/torch_ext/parent --kernel dkv  # dk/dv backward

Builds ``<other>/edgestyle_tpu_torch/kernels/flash_fwd.cu`` (``--kernel
fwd``) or ``flash_bwd.cu`` (``--kernel dq`` or ``dkv``) with this checkout's
nvcc flags and its own headers beside it, into ``build/torch_ext/ab/``;
checks it and this checkout's kernel against the plain version with
``chip_smoke.py``'s tolerances at the timed shapes and at chip_smoke's
checked-only shapes; then at each timed shape (``chip_smoke.FLASH_SHAPES``
for the forward, ``FLASH_BWD_SHAPES`` for dq and dk/dv) times other, this,
this, other and one library call (SDPA's forward, or SDPA's whole backward,
dq, dk and dv together), with CUDA events around calls
queued behind a sleep kernel, as ``chip_smoke.py`` times them. To time a
variant of a kernel, unpack the variant into a directory of its own, as the
parent is unpacked. Prints the card's name and power limit first; exits
non-zero on a failed build or check.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from edgestyle_tpu_torch import kernels  # noqa: E402
from edgestyle_tpu_torch.ops import flash  # noqa: E402

LIBRARY = {"fwd": "flash_fwd", "dq": "flash_bwd", "dkv": "flash_bwd"}


def build_other(other: Path, name: str) -> ctypes.CDLL:
    """The other checkout's source of library `name`, built with its own
    headers."""
    kdir = other / "edgestyle_tpu_torch" / "kernels"
    src = kdir / kernels.SOURCES[name][0]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(kdir.glob("*.cuh")):
        h.update(header.read_bytes())
    out = kernels.BUILD_DIR / "ab" / f"{name}-other-{h.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "Performance", "C7520")):
            print(f"  ptxas other: {line.strip()}", flush=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc failed for {src}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in kernels.SOURCES[name][1].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def other_fwd(lib):
    """flash_attention_cuda's launch, through `lib`, on contiguous
    (1, BH, N, D) bf16 tensors."""
    def fwd(q, k, v, scale):
        _, bh, n, d = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.check(lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    lse.data_ptr(), bh, n, d, float(scale), stream), "other")
        return out, lse
    return fwd


def other_dq(lib):
    """flash_bwd_dq_cuda's launch, through `lib`, on contiguous (1, BH, N, D)
    bf16 tensors and (1, BH, N) fp32 lse and D."""
    def dq(q, k, v, do, lse, delta, scale):
        _, bh, n, d = q.shape
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.check(lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                       lse.data_ptr(), delta.data_ptr(), out.data_ptr(), bh, n,
                                       d, float(scale), stream), "other")
        return out
    return dq


def other_dkv(lib):
    """flash_bwd_dkv_cuda's launch, through `lib`, on contiguous
    (1, BH, N, D) bf16 tensors and (1, BH, N) fp32 lse and D."""
    def dkv(q, k, v, do, lse, delta, scale):
        _, bh, n, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernels.check(lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                        dv.data_ptr(), bh, n, d, float(scale), stream), "other")
        return dk, dv
    return dkv


def in_turns(fns, args) -> dict:
    """other, this, this, other: {name: [ms, ms]}."""
    times = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        times[name].append(chip_smoke.time_ms(lambda: fns[name](*args)))
    return times


def ab_fwd(lib, gen, dev) -> list:
    fns = {"other": other_fwd(lib), "this": flash.flash_attention_cuda}
    bad = []
    for bh, n, d in chip_smoke.FLASH_SHAPES + chip_smoke.FLASH_CHECK_SHAPES:
        q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        checks = {name: chip_smoke.flash_check(q, k, v, scale, fn) for name, fn in fns.items()}
        txt = "; ".join(f"{name} max_abs_err={e:.3e} (tol {t:.3e}) lse_err={le:.3e}"
                        for name, (e, t, le) in checks.items())
        if (bh, n, d) in chip_smoke.FLASH_CHECK_SHAPES:
            print(f"flash_fwd BH={bh} N={n} D={d}: {txt} (checked, not timed)", flush=True)
        else:
            times = in_turns(fns, (q, k, v, scale))
            sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            b_ms, b_by = chip_smoke.flash_bound_ms(bh, n, d)
            print(f"flash_fwd BH={bh} N={n} D={d}: other ms {times['other']} this ms "
                  f"{times['this']} sdpa_ms={sdpa:.4f} bound_ms={b_ms:.4f} ({b_by}); {txt}",
                  flush=True)
        e, t, le = checks["this"]
        if not (e <= t and le <= chip_smoke.LSE_TOL):
            bad.append((bh, n, d))
    return bad


def ab_bwd(kernel, lib, gen, dev) -> list:
    """dq (`kernel` "dq") or dk/dv ("dkv") of `lib` and of this checkout."""
    fns = {"other": (other_dq if kernel == "dq" else other_dkv)(lib),
           "this": flash.flash_bwd_dq_cuda if kernel == "dq" else flash.flash_bwd_dkv_cuda}
    bad = []
    for bh, n, d in chip_smoke.FLASH_BWD_SHAPES + chip_smoke.FLASH_BWD_CHECK_SHAPES:
        args = chip_smoke.flash_bwd_inputs(gen, dev, bh, n, d)
        checks = {name: chip_smoke.flash_bwd_errors(
                      args, dq_fn=fn if kernel == "dq" else False,
                      dkv_fn=fn if kernel == "dkv" else False)
                  for name, fn in fns.items()}
        txt = "; ".join(f"{name} " + ", ".join(f"{g} max_abs_err={e:.3e} (tol {t:.3e})"
                                               for g, (e, t, _) in errs.items())
                        for name, errs in checks.items())
        if (bh, n, d) in chip_smoke.FLASH_BWD_CHECK_SHAPES:
            print(f"flash_bwd_{kernel} BH={bh} N={n} D={d}: {txt} (checked, not timed)",
                  flush=True)
        else:
            times = in_turns(fns, args)
            sdpa = chip_smoke.sdpa_backward_ms(*args[:4])
            b_ms, b_by = chip_smoke.flash_bwd_bound_ms(bh, n, d, 3 if kernel == "dq" else 4)
            print(f"flash_bwd_{kernel} BH={bh} N={n} D={d}: other ms {times['other']} this ms "
                  f"{times['this']} sdpa_backward_ms={sdpa:.4f} bound_ms={b_ms:.4f} ({b_by}); "
                  f"{txt}", flush=True)
        if not all(e <= t for e, t, _ in checks["this"].values()):
            bad.append((bh, n, d))
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--kernel", choices=sorted(LIBRARY), default="fwd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false; this script needs one GPU")
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    lib = build_other(args.other.resolve(), LIBRARY[args.kernel])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if args.kernel == "fwd":
        bad = ab_fwd(lib, gen, dev)
    else:
        bad = ab_bwd(args.kernel, lib, gen, dev)
    if bad:
        chip_smoke.fail(f"this checkout's kernel disagrees with the plain version at {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

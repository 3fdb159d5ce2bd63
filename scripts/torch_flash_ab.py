"""Time the port's flash forward kernel against another checkout's, in turns
on one card (PyTorch/CUDA port, ``edgestyle_tpu_torch``).

    mkdir -p build/torch_ext/parent
    git archive <commit> | tar -x -C build/torch_ext/parent
    python3 scripts/torch_flash_ab.py build/torch_ext/parent

Builds ``<other>/edgestyle_tpu_torch/kernels/flash_fwd.cu`` with this
checkout's nvcc flags (its own headers beside it) into
``build/torch_ext/ab/``, checks it and this checkout's kernel against the
plain version with ``chip_smoke.py``'s tolerances, then at each of
``chip_smoke.FLASH_SHAPES`` times other, this, this, other and one SDPA call
(CUDA events, calls queued behind a sleep kernel, as ``chip_smoke.py`` times
them). Prints the card's name and power limit first; exits non-zero on a
failed build or check.
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


def build_other(other: Path) -> ctypes.CDLL:
    src = other / "edgestyle_tpu_torch" / "kernels" / "flash_fwd.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = kernels.BUILD_DIR / "ab" / f"flash_fwd-other-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout.splitlines():
        if any(w in line for w in ("registers", "spill", "error", "Performance")):
            print(f"  ptxas other: {line.strip()}", flush=True)
    if proc.returncode != 0:
        chip_smoke.fail(f"nvcc failed for {src}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out))
    lib.flash_fwd.argtypes = list(kernels.SOURCES["flash_fwd"][1]["flash_fwd"])
    lib.flash_fwd.restype = ctypes.c_int
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false; this script needs one GPU")
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    fwd_other = other_fwd(build_other(args.other.resolve()))
    fwd_this = flash.flash_attention_cuda
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bad = []
    for bh, n, d in chip_smoke.FLASH_SHAPES + chip_smoke.FLASH_CHECK_SHAPES:
        q, k, v = (torch.randn((1, bh, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        checks = {name: chip_smoke.flash_check(q, k, v, scale, fn)
                  for name, fn in (("other", fwd_other), ("this", fwd_this))}
        txt = "; ".join(f"{name} max_abs_err={e:.3e} (tol {t:.3e}) lse_err={le:.3e}"
                        for name, (e, t, le) in checks.items())
        ok = {name: e <= t and le <= chip_smoke.LSE_TOL for name, (e, t, le) in checks.items()}
        if (bh, n, d) in chip_smoke.FLASH_CHECK_SHAPES:
            print(f"flash_fwd BH={bh} N={n} D={d}: {txt} (checked, not timed)", flush=True)
        else:
            times = {"other": [], "this": []}
            for name in ("other", "this", "this", "other"):
                fn = fwd_other if name == "other" else fwd_this
                times[name].append(chip_smoke.time_ms(lambda: fn(q, k, v, scale)))
            sdpa = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            b_ms, b_by = chip_smoke.flash_bound_ms(bh, n, d)
            print(f"flash_fwd BH={bh} N={n} D={d}: other ms {times['other']} this ms "
                  f"{times['this']} sdpa_ms={sdpa:.4f} bound_ms={b_ms:.4f} ({b_by}); {txt}",
                  flush=True)
        if not ok["this"]:
            bad.append((bh, n, d))
    if bad:
        chip_smoke.fail(f"this checkout's kernel disagrees with the plain version at {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""torch-pickle -> safetensors checkpoint converter.

Counterpart of edgestyle_tpu/apps/convert_checkpoint.py. The reference
distributes EfficientViT-SAM weights as torch pickles (l2.pt and four
finetuned trained_model_*.pt); the apps read either format
(core/porting.py::load_state_dict), and this converts once so that a
deployment never unpickles at start-up. It writes through the port's own
safetensors writer (core/safetensors.py), in each tensor's dtype.

    python -m edgestyle_tpu_torch.apps.convert_checkpoint src.pt dst.safetensors
"""

from __future__ import annotations

import argparse

from edgestyle_tpu_torch.core.porting import load_torch_checkpoint
from edgestyle_tpu_torch.core.safetensors import save_file


def convert(src: str, dst: str) -> int:
    """Write ``src``'s state dict to ``dst``; returns the tensor count."""
    sd = load_torch_checkpoint(src)
    save_file(sd, dst)
    return len(sd)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="torch checkpoint (.pt/.pth/.ckpt)")
    p.add_argument("dst", help="output .safetensors path")
    args = p.parse_args(argv)
    n = convert(args.src, args.dst)
    print(f"wrote {args.dst} ({n} tensors)")


if __name__ == "__main__":
    main()

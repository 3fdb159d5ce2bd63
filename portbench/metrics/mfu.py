"""Model FLOP utilisation of the measured window: the plain reference's
FLOPs per item (an image's generation, or a training sample's forward and
backward, counted on the meta device at the cell's shapes) x items per
second / the chip's bf16 peak. One reader for every split (``mfu.gen``,
``mfu.train``)."""

from portbench.roofline import PEAK_FLOPS


def read(run):
    if not run.get("flops_per_item") or not run.get("rate"):
        return None
    return 100.0 * run["flops_per_item"] * run["rate"] / PEAK_FLOPS

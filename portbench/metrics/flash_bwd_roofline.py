"""The flash backward kernels' share of their roofline over the traced
training steps: the sum of each call's bound over the sum of its device
time (``edgestyle::flash_bwd_dq`` + ``edgestyle::flash_bwd_dkv``)."""

from portbench.roofline import roofline_pct


def read(run):
    tr = run.get("trace")
    return roofline_pct(tr["ops"], ("edgestyle::flash_bwd_dq",
                                    "edgestyle::flash_bwd_dkv")) if tr else None

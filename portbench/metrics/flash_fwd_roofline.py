"""The flash forward kernel's share of its roofline over the traced
generation units: the sum of each call's bound over the sum of its device
time (``edgestyle::flash_fwd``)."""

from portbench.roofline import roofline_pct


def read(run):
    tr = run.get("trace")
    return roofline_pct(tr["ops"], ("edgestyle::flash_fwd",)) if tr else None

"""The fused GroupNorm-SiLU-conv3x3's share of its roofline over the
traced generation units: its two operators' bounds over their device time
(``edgestyle::gn_scale_shift`` + ``edgestyle::fused_gn_silu_conv3x3``)."""

from portbench.roofline import roofline_pct


def read(run):
    tr = run.get("trace")
    return roofline_pct(tr["ops"], ("edgestyle::gn_scale_shift",
                                     "edgestyle::fused_gn_silu_conv3x3")) if tr else None

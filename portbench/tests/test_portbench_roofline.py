"""The kernels' FLOP and byte formulas against hand counts, two shapes
each, and the share of the roofline a set of calls gives."""

import pytest

from portbench import roofline as rl

BF, F32 = "c10::BFloat16", "float"


@pytest.mark.parametrize("q,kv,flops,nbytes", [
    # (B, H, N, D) self-attention at the UNet's first level, B=2 rows
    ((2, 8, 4096, 40), (2, 8, 4096, 40), 4 * 2 * 8 * 4096 * 4096 * 40,
     4 * (2 * 8 * 4096 * 40 * 2) + 2 * 8 * 4096 * 4),
    # a short query against 77 keys
    ((1, 2, 64, 16), (1, 2, 77, 16), 4 * 1 * 2 * 64 * 77 * 16,
     2 * (1 * 2 * 64 * 16 * 2) + 2 * (1 * 2 * 77 * 16 * 2) + 1 * 2 * 64 * 4),
])
def test_flash_fwd(q, kv, flops, nbytes):
    assert rl.flash_fwd([list(q), list(kv), list(kv), []], [BF, BF, BF, "Scalar"]) == (
        flops, nbytes)


@pytest.mark.parametrize("n,d", [(4096, 40), (1024, 80)])
def test_flash_bwd(n, d):
    b, h = 2, 8
    t = [b, h, n, d]
    shapes = [t, t, t, t, [b, h, n], [b, h, n], []]
    dtypes = [BF, BF, BF, BF, F32, F32, "Scalar"]
    ins = 4 * (b * h * n * d * 2) + 2 * (b * h * n * 4)
    assert rl.flash_bwd_dq(shapes, dtypes) == (6 * b * h * n * n * d, ins + b * h * n * d * 2)
    assert rl.flash_bwd_dkv(shapes, dtypes) == (8 * b * h * n * n * d,
                                                ins + 2 * b * h * n * d * 2)


@pytest.mark.parametrize("b,cin,hw,cout", [(2, 320, 64, 320), (16, 1920, 32, 640)])
def test_fused_conv_and_gn(b, cin, hw, cout):
    x = [b, cin, hw, hw]
    conv = rl.fused_gn_silu_conv3x3([x, [b, cin], [b, cin], [cout, cin, 3, 3], [cout]],
                                    [BF, F32, F32, BF, BF])
    assert conv == (2 * b * hw * hw * cin * cout * 9,
                    b * cin * hw * hw * 2 + 2 * b * cin * 4 + cout * cin * 9 * 2 + cout * 2
                    + b * cout * hw * hw * 2)
    gn = rl.gn_scale_shift([x, [cin], [cin], [], []], [BF, F32, F32, "Scalar", "Scalar"])
    assert gn == (0, b * cin * hw * hw * 2 + 2 * cin * 4 + 2 * b * cin * 4)


def test_roofline_share():
    call = {"shapes": [[2, 8, 4096, 40]] * 3 + [[]], "dtypes": [BF] * 3 + ["Scalar"]}
    bound = rl.bound_s("edgestyle::flash_fwd", call["shapes"], call["dtypes"])
    assert bound == pytest.approx(4 * 2 * 8 * 4096 ** 2 * 40 / rl.PEAK_FLOPS)
    calls = {"edgestyle::flash_fwd": [dict(call, device_s=2 * bound)] * 2}
    assert rl.roofline_pct(calls, ("edgestyle::flash_fwd",)) == pytest.approx(50.0)
    # nothing to read: no value, never a 0
    assert rl.roofline_pct({}, ("edgestyle::flash_fwd",)) is None

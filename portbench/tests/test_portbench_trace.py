"""The trace reductions on hand-made profiler events: the busy union, the
window and the kernels counted; an operator's device time through its
nested operators, and the idle gaps named by the host operator that ended
them."""

from pytest import approx
from torch.autograd import DeviceType

from portbench import trace


class Ev:
    def __init__(self, name, dev, start, end, corr=0, linked=0, tid=1, shapes=(), dtypes=()):
        self._a = dict(name=name, device_type=dev, start_ns=start, end_ns=end,
                       correlation_id=corr, linked_correlation_id=linked,
                       start_thread_id=tid, shapes=list(shapes), dtypes=list(dtypes))

    def __getattr__(self, k):
        return lambda: self._a[k]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_reduce():
    events = [
        Ev(trace.MARK, CPU, 0, 1000),
        Ev(trace.MARK, CUDA, 0, 1000),  # the device copy of the range: not an operation
        Ev("edgestyle::flash_fwd", CPU, 100, 200, corr=1, shapes=[[1, 1, 4, 4]],
           dtypes=["c10::BFloat16"]),
        Ev("aten::empty_like", CPU, 110, 120, corr=2),  # nested in the operator
        Ev("aten::mul", CPU, 300, 320, corr=3),
        Ev("cudaLaunchKernel", CPU, 150, 160, corr=9),  # a runtime call, not an operator
        Ev("flash_fwd_kernel", CUDA, 200, 400, linked=1),
        Ev("fill_kernel", CUDA, 350, 450, linked=2),
        Ev("Memcpy DtoH", CUDA, 600, 700, linked=3),
        Ev("mul_kernel", CUDA, 800, 900, linked=3),
    ]
    dev = trace.device_summary(events)
    assert dev["window_s"] == approx((900 - 200) * 1e-9)  # first start to last end
    assert dev["busy_s"] == approx((450 - 200 + 100 + 100) * 1e-9)
    assert dev["kernels"] == 3  # the copy is a device operation, not a launch
    assert dev["device_ops"][0] == ["flash_fwd_kernel", approx(200e-9)]
    out = trace.host_summary(events, 0, 1000)
    (call,) = out["ops"]["edgestyle::flash_fwd"]
    assert call["device_s"] == approx((200 + 100) * 1e-9)
    gaps = dict(out["idle_gaps"])
    assert gaps["edgestyle::flash_fwd"] == approx(200e-9)
    assert gaps["aten::mul"] == approx((150 + 100) * 1e-9)
    assert gaps["after the last operation"] == approx(100e-9)

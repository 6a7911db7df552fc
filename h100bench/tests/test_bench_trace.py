"""The reduction of a profiler's events: the window, the union of device
intervals, kernels attributed to the span that launched them (a graph's
kernels by the graph launch's correlation id), idle time by host span."""

from h100bench.trace import PREFIX, base_name, summarize


class Event:
    def __init__(self, name, device, start, dur, corr=0, annotation=False):
        self._n, self._d, self._s, self._dur = name, device, start, dur
        self._c, self._a = corr, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._a


def test_summary():
    events = [
        Event(PREFIX + "window", False, 0, 1000, annotation=True),
        Event(PREFIX + "window", True, 0, 1000, annotation=True),  # the device's mirror
        Event(PREFIX + "pool.step", False, 100, 50, annotation=True),
        Event(PREFIX + "pool.admit", False, 400, 100, annotation=True),
        Event("cudaGraphLaunch", False, 110, 5, corr=7),
        Event("cudaLaunchKernel", False, 410, 5, corr=9),
        Event("void small_kv_fwd_tc_kernel<64>(float*)", True, 200, 100, corr=7),
        Event("void small_kv_fwd_tc_kernel<64>(float*)", True, 250, 100, corr=7),  # union 200-350
        Event("void (anonymous namespace)::flash_fwd_tc_kernel(int)", True, 600, 200, corr=9),
        Event("outside", True, 1200, 100, corr=11),  # after the window
    ]
    s = summarize(events)
    assert s.window_s == 1000 / 1e9
    assert s.busy_s == (150 + 200) / 1e9
    assert s.kernel_seconds(("small_kv_",), span="pool.step") == 200 / 1e9
    assert s.kernel_seconds(("flash_",), span="pool.step") == 0.0
    assert s.kernel_seconds(("flash_",), span="pool.admit") == 200 / 1e9
    assert s.device_ops[0] == ("void small_kv_fwd_tc_kernel<64>(float*)", 200 / 1e9)
    # gaps 0-200, 350-600 and 800-1000 all begin outside a harness span
    assert [n for n, _ in s.idle_gaps] == ["outside_spans"]
    assert abs(s.idle_gaps[0][1] - 650 / 1e9) < 1e-15


def test_base_names():
    assert base_name("void (anonymous namespace)::mha_bwd_dq_tc_kernel<64>(__nv_bfloat16 const*)") \
        == "mha_bwd_dq_tc_kernel"
    assert base_name("skv_bwd_reduce_kernel(float*, int)") == "skv_bwd_reduce_kernel"
    assert base_name("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"
    assert base_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD "


def test_no_window_no_summary():
    assert summarize([Event("k", True, 0, 10)]) is None

"""The trace arithmetic: busy time is the union of the device operations
over the whole traced window, idle gaps go to the innermost host span
over them, and the marker kernel ties the clocks."""

import pytest
from torch.autograd import DeviceType

import tracing as T


class Ev:
    def __init__(self, name, a, b, dev=DeviceType.CUDA):
        self._n, self._a, self._b, self._d = name, a, b, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d


class Fake(T.DeviceTrace):
    def __init__(self, events, host_open, host_close):
        super().__init__()
        self.prof = type("P", (), {})()
        self.prof.profiler = type("Q", (), {})()
        self.prof.profiler.kineto_results = type(
            "R", (), {"events": lambda self_: events})()
        self.host_open_ns, self.host_close_ns = host_open, host_close


def test_busy_idle_and_attribution():
    base = 5_000_000      # the profiler's clock; the host's is 1000 later
    ev = [Ev("void at::cuda::(anonymous namespace)::spin_kernel(long)", base, base + 10),
          Ev("k1", base + 100, base + 300), Ev("k2", base + 200, base + 400),
          Ev("k1", base + 700, base + 800),
          Ev("aten::cpu_op", base + 0, base + 999, DeviceType.CPU)]
    tr = Fake(ev, 1000, 2000)
    spans = [("session", 1000, 2000), ("A", 1400, 1600), ("B", 1450, 1550)]
    s = T.summarize(tr, spans)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(400e-9)        # 100-400, 700-800
    assert s["ops"]["k1"] == [pytest.approx(300e-9), 2]
    assert "spin_kernel" not in s["ops"] and s["n_ops"] == 3
    idle = s["idle_by_span"]
    # gaps 0-100, 400-700, 800-1000 on the device clock = host +1000
    assert idle["B"] == pytest.approx(100e-9)
    assert idle["A"] == pytest.approx(100e-9)
    assert idle["session"] == pytest.approx(400e-9)
    assert sum(idle.values()) == pytest.approx(600e-9)


def test_no_marker_is_an_error():
    with pytest.raises(RuntimeError):
        Fake([Ev("k1", 0, 5)], 0, 10).device_ops()

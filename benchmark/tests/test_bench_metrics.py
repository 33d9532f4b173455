"""The metric arithmetic and the plain reference on fixed data."""
import numpy as np
import pytest
import torch

from benchmark import readers, reference, roofline, timing, trace


class Ev:
    def __init__(self, name, act, s, e):
        self._n, self._a, self._s, self._e = name, act, s, e

    def name(self):
        return self._n

    def activity_type(self):
        return self._a

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


EVENTS = [
    Ev(trace.WINDOW, "user_annotation", 0, 100),
    Ev("bench.step", "user_annotation", 0, 50),
    Ev("bench.pace", "user_annotation", 50, 100),
    Ev("void (anonymous namespace)::pyramid_kernel<true>(float const*)", "kernel", 10, 30),
    Ev("void gemm(float*)", "kernel", 20, 40),
    Ev("Memcpy DtoD", "gpu_memcpy", 60, 70),
    Ev("bench.step", "gpu_user_annotation", 0, 100),  # not device work
    Ev("void late()", "kernel", 95, 130),  # clipped to the window
]


def test_trace_summary():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["busy_s"] == pytest.approx(45e-9)  # [10, 40] + [60, 70] + [95, 100]
    assert s["idle_gaps"][0] == ["bench.pace", pytest.approx(25e-9)]  # [70, 95]
    assert s["idle_gaps"][1] == ["bench.step", pytest.approx(20e-9)]  # [40, 60]
    assert s["idle_gaps"][2] == ["bench.step", pytest.approx(10e-9)]  # [0, 10]
    assert s["kernel_s"] == {"pyramid": pytest.approx(20e-9)}
    assert s["device_ops"][0][0] in ("void (anonymous namespace)::pyramid_kernel<true>"
                                     "(float const*)", "void gemm(float*)")
    record = {"path": "offline", "trace": s}
    assert readers.idle_pct(record, "offline") == pytest.approx(55.0)
    assert readers.idle_pct(record, "online") is None
    assert trace.summarize(EVENTS[1:]) is None  # no window: nothing to read


def test_roofline_share():
    shape = (2, 11, 480, 752, 3)
    nbytes, ops = roofline.cost("pyramid_scharr", shape)
    hw = [(480, 752), (240, 376), (120, 188), (60, 94)]
    px = sum(h * w for h, w in hw)
    assert nbytes == 4 * 11 * (2 * 480 * 752 + 2 * (px - 480 * 752) + 2 * px)
    least = max(nbytes / 3.35e12, ops / 67e12)
    got = roofline.share_pct({("pyramid_scharr", shape): 3}, {"pyramid": 6 * least})
    assert got == pytest.approx(50.0)
    assert roofline.share_pct({}, {"pyramid": 1.0}) is None
    assert roofline.share_pct({("greedy_nms", (11, 400, "per-lane")): 1}, {}) is None
    record = {"path": "online", "trace": {"kernel_s": {"pyramid": 6 * least}},
              "launches": {("pyramid_scharr", shape): 3}}
    assert readers.kernels_roofline(record, "online") == pytest.approx(50.0)


def test_rate_and_tail():
    assert timing.rate(11 * 150, 30.0) == pytest.approx(55.0)
    lat = list(range(1, 201))  # 200 frames: the tail is over all of them
    assert timing.tail_ms(lat) == pytest.approx(np.percentile(lat, 95))
    assert timing.tail_ms([]) == float("inf")


def test_alignment_removes_a_rigid_motion():
    rng = np.random.RandomState(0)
    gt = rng.randn(50, 3)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = gt @ R.T + [1.0, -2.0, 0.5]
    assert reference.aligned_errors(est, gt).max() < 1e-12
    est[17] += [0.0, 0.0, 0.3]
    assert reference.aligned_errors(est, gt).max() > 0.25
    est[3] = np.nan
    assert np.isinf(reference.aligned_errors(est, gt)).all()


def test_pyramid_reference_matches_the_ports_plain_version():
    from hybvio_tpu_torch.ops.pyramid import pyramid_with_gradients_plain

    u8 = torch.randint(0, 256, (2, 37, 53), dtype=torch.uint8)
    lv, grads = reference.pyramid(u8, 3)
    pyrs, pgrads = pyramid_with_gradients_plain([u8.to(torch.float32) / 255.0], 3)
    for a, b in zip(lv[1:], pyrs[0]):
        assert (a - b.double()).abs().max() < 1e-6
    for (ax, ay), (bx, by) in zip(grads, pgrads):
        assert (ax - bx.double()).abs().max() < 1e-6 and (ay - by.double()).abs().max() < 1e-6


class OldEv(Ev):
    """An event of a build whose kineto events have no activity_type()."""

    def __init__(self, name, act, s, e):
        super().__init__(name, act, s, e)
        self._dev = "DeviceType.CUDA" if act.startswith("gpu") or act == "kernel" else \
            "DeviceType.CPU"

    def device_type(self):
        return self._dev

    activity_type = property()  # hasattr() is False


def test_trace_summary_without_activity_types():
    old = [OldEv(e._n, e._a, e._s, e._e) for e in EVENTS]
    assert not hasattr(old[0], "activity_type")
    assert trace.summarize(old) == trace.summarize(EVENTS)


def test_the_line_stays_json():
    import json

    from benchmark.run import plain

    line = {"check": {"pose_err_m": {"value": float("inf"), "limit": 5.0}},
            "metrics": {"frame_ms_p95": {"value": float("nan"), "unit": "ms"}},
            "breakdown": {"idle_gaps": [["bench.step", 0.5]]}}
    got = json.loads(json.dumps(plain(line), allow_nan=False))
    assert got["check"]["pose_err_m"] == {"value": None, "limit": 5.0}
    assert got["metrics"]["frame_ms_p95"]["value"] is None
    assert got["breakdown"]["idle_gaps"] == [["bench.step", 0.5]]

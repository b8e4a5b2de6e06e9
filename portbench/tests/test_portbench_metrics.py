"""The metric readers' arithmetic on synthetic inputs."""

import pytest

from portbench import harness


def read(name, stats=None, trace=None):
    return harness.metric_reader(name)(dict(stats=stats or {}, trace=trace))


def test_rate_over_the_window():
    assert read("frames_per_s", dict(frames=120, window_s=40.0)) == 3.0
    assert read("frames_per_s", dict(window_s=1.0)) is None


def test_p95_over_all_gaps():
    # 3 of every 4 frames arrive with their chunk; chunk gaps 0.4-0.59 s
    gaps = []
    for i in range(20):
        gaps += [0.4 + 0.01 * i, 0.0, 0.0, 0.0]
    v = sorted(gaps)
    pos = (len(v) - 1) * 0.95
    want = 1e3 * (v[int(pos)] + (v[int(pos) + 1] - v[int(pos)])
                  * (pos - int(pos)))
    assert read("frame_gap_p95_ms", dict(gaps_s=gaps)) == pytest.approx(want)
    assert read("frame_gap_p95_ms", dict(gaps_s=[0.25])) == 250.0


def synthetic_trace(units=2):
    ev = [
        dict(ph="X", cat="kernel", name="void warp_march_kernel<false>()",
             ts=0.0, dur=400.0),
        dict(ph="X", cat="kernel", name="void probe_kernel()", ts=400.0,
             dur=100.0),
        dict(ph="X", cat="kernel", name="void at::native::roll_cuda_kernel()",
             ts=600.0, dur=200.0),
        dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=950.0,
             dur=50.0),
        dict(ph="X", cat="cpu_op", name="aten::item", ts=450.0, dur=200.0),
        dict(ph="X", cat="cpu_op", name="outer", ts=0.0, dur=1000.0),
    ]
    return harness.Trace(ev, window_s=2000e-6, units=units)


def test_groups_and_idle_share():
    tr = synthetic_trace()
    assert tr.busy_s() == pytest.approx(750e-6)
    assert read("marcher_ms.pile", trace=tr) == pytest.approx(0.25)
    assert read("torch_ms.pile", trace=tr) == pytest.approx(0.125)
    assert read("device_idle_pct.pile", trace=tr) == pytest.approx(62.5)
    gaps = tr.idle_gaps()
    assert gaps[0][0] == "outer" and gaps[0][1] == pytest.approx(150e-6)
    assert gaps[1][0] == "aten::item" and gaps[1][1] == pytest.approx(100e-6)


def test_a_group_that_did_not_run_reads_none():
    tr = synthetic_trace()
    assert read("raster_ms.pile", trace=tr) is None
    assert read("bounce_ms.pile", trace=tr) is None
    assert read("marcher_ms.pile", trace=None) is None


def test_overlapping_events_merge():
    ev = [dict(ph="X", cat="kernel", name="a", ts=0.0, dur=10.0),
          dict(ph="X", cat="kernel", name="b", ts=5.0, dur=10.0)]
    assert harness.Trace(ev, 1.0, 1).busy_s() == pytest.approx(15e-6)


def test_a_metric_finds_its_quantity_file():
    """``<quantity>.<part>`` reads ``metrics/<quantity>.py``; the torch
    group leaves out every kernel that another layer's reader names."""
    assert harness.metric_module("marcher_ms.pile").__file__.endswith(
        "metrics/marcher_ms.py")
    torch_ms = harness.metric_module("torch_ms.pile")
    for layer in ("marcher_ms", "raster_ms", "bounce_ms"):
        assert set(harness.metric_module(layer).KERNELS) <= \
            set(torch_ms.LIBRARY)

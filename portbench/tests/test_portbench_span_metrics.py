"""The readers of the program's spans (``spans.py``) on synthetic traces:
the device's idle time split by the fused loop's host phase, a gap under
no span counted by none, None where a span never appeared, and the
share of overflowing schedule waves."""

import pytest

from portbench import harness, spans

SPAN_METRICS = ("file_idle_ms.pile", "queue_idle_ms.pile",
                "deliver_idle_ms.pile", "sync_wait_ms.pile",
                "syncs_per_frame.pile", "overflow_share.pile")


def read(name, trace):
    return harness.metric_reader(name)(dict(stats={}, trace=trace))


def kernel(ts, dur, name="void warp_march_kernel<false>()"):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur)


def span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)


def window(units=2):
    """Device busy 0-100, 300-400, 600-700, 900-1000 and 1200-1300 us;
    idle 100-300 (under fused.file to 150, then fused.chunk), 400-600
    (fused.chunk 450-550), 700-900 (fused.deliver to 800) and 1000-1200
    (under no span at all)."""
    ev = [kernel(t, 100.0) for t in (0.0, 300.0, 600.0, 900.0, 1200.0)]
    ev += [
        span("fused.file", 50.0, 100.0),           # idle 100-150
        span("fused.rebuild", 60.0, 80.0),
        span("fused.chunk", 150.0, 200.0),         # idle 150-300
        span("fused.chunk", 450.0, 100.0),         # idle 450-550
        span("sync.pair_count", 200.0, 100.0),
        span("sync.pair_count", 500.0, 120.0),
        span("fused.deliver", 650.0, 150.0),       # idle 700-800
        span("sync.fetch", 650.0, 140.0),
        span("route.raster", 180.0, 130.0),
        span("route.raster", 480.0, 150.0),
        span("route.overflow", 630.0, 10.0),
        span("route.raster", 900.0, 20.0),
    ]
    return harness.Trace(ev, window_s=1300e-6, units=units)


def test_idle_split_by_phase():
    tr = window()
    assert read("file_idle_ms.pile", tr) == pytest.approx(0.050 / 2)
    # 150 + 100 us under the two chunk spans
    assert read("queue_idle_ms.pile", tr) == pytest.approx(0.250 / 2)
    assert read("deliver_idle_ms.pile", tr) == pytest.approx(0.100 / 2)


def test_a_gap_under_no_span_counts_in_none():
    tr = window()
    idle_us = sum(e - s for s, e in spans.idle_intervals(tr))
    assert idle_us == pytest.approx(800.0)
    phases = sum(read(m, tr) for m in ("file_idle_ms.pile",
                                        "queue_idle_ms.pile",
                                        "deliver_idle_ms.pile"))
    # 400-450, 550-600, 800-900 and 1000-1200 lie under no phase: the
    # caller's
    assert phases * 2 == pytest.approx((800.0 - 400.0) / 1e3)
    assert spans.idle_intervals(tr) == [(100.0, 300.0), (400.0, 600.0),
                                        (700.0, 900.0), (1000.0, 1200.0)]


def test_syncs_count_and_wait():
    tr = window()
    assert read("syncs_per_frame.pile", tr) == pytest.approx(3 / 2)
    assert read("sync_wait_ms.pile", tr) == pytest.approx(0.360 / 2)


def test_overflow_share():
    assert read("overflow_share.pile", window()) == pytest.approx(100 / 3)


def test_none_where_a_span_is_absent():
    """The parent's trace: device work, no span of the program."""
    tr = harness.Trace([kernel(0.0, 10.0), kernel(50.0, 10.0)], 1e-4, 1)
    for name in SPAN_METRICS:
        assert read(name, tr) is None, name
        assert read(name, None) is None, name
    only_overflow = harness.Trace(
        [kernel(0.0, 10.0), span("route.overflow", 0.0, 5.0)], 1e-4, 1)
    assert read("overflow_share.pile", only_overflow) is None
    no_overflow = harness.Trace(
        [kernel(0.0, 10.0), span("route.raster", 0.0, 5.0)], 1e-4, 1)
    assert read("overflow_share.pile", no_overflow) == 0.0


def test_a_span_over_no_idle_time_reads_zero():
    tr = harness.Trace([kernel(0.0, 100.0), span("fused.file", 10.0, 50.0)],
                       1e-4, 1)
    assert read("file_idle_ms.pile", tr) == 0.0


def test_span_metrics_are_entries_of_the_manifest():
    per = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in SPAN_METRICS:
        m = per[name]
        assert m["workloads"] == ["pile_whitted_anim", "pile_path_anim"]
        assert m["moves"] == "frames_per_s" and m["better"] == "lower"
    assert (per["overflow_share.pile"]["layer"]
            == per["raster_ms.pile"]["layer"])

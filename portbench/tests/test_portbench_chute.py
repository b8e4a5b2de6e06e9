"""The chute cell (``chute_whitted_anim``) and its generator: the bed is
frozen (the same poses for a seed, no two particles overlapping in any
file, 32,000 particles, the configuration's triangle count), and a small
rehearsal of the cell on the CPU through ``drivers/chute_stream``, judged
as ``run.py`` judges it: sound runs come out correct, the control (the
reference in bfloat16) and a planted fault do not.  ``pile_path_overflow``
rehearses through ``time_stream`` like the pile cells."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import chute_stream, time_stream
from portbench.gen import chute, pile

TINY_CHUTE = dict(width=48, height=32, particles=96)


def test_chute_bed_is_frozen():
    a = chute.bed_poses(chute.N_PARTICLES, chute.ANIM_TIMES)
    b = chute.bed_poses(chute.N_PARTICLES, chute.ANIM_TIMES)
    assert len(a) == len(chute.ANIM_TIMES)
    for x, y in zip(a, b):
        for k in ("pos", "quat", "vel", "sid", "ids"):
            np.testing.assert_array_equal(x[k], y[k])
    f0, f2 = a[0], a[2]
    assert f0["pos"].shape == (32000, 3) == (chute.N_PARTICLES, 3)
    # pinned at seed 7: a change to the generator moves these
    np.testing.assert_allclose(f0["pos"][[0, 1599, 31999]], [
        [-41.1972747266, -34.7976350481, 1.0489412701],
        [40.1597489876, 34.7713781553, 1.0424725243],
        [40.1698404208, 34.8032693304, 39.8220353117]], atol=1e-9)
    np.testing.assert_allclose(f2["pos"][31999],
                               [42.1619347266, 34.8032693304,
                                39.8220353117], atol=1e-9)
    np.testing.assert_allclose(f2["quat"][5], [-0.9161691759, -0.1137448793,
                                               0.1822993023, -0.338323969],
                               atol=1e-9)
    assert np.bincount(f0["sid"], minlength=3).tolist() == \
        [10606, 10608, 10786]
    assert abs(float(f0["pos"].sum()) - 637283.6537498194) < 1e-6
    assert abs(float(f2["pos"].sum()) - 675693.0645109031) < 1e-6
    cfg = harness.config("dem_chute")
    counts = [len(v) for v, _ in chute.library_shapes()]
    assert cfg["particles"] == 32000
    assert cfg["triangles"] == sum(counts[s] for s in f0["sid"]) + 2


def test_chute_bed_has_no_overlaps():
    for f in chute.bed_poses(chute.N_PARTICLES, chute.ANIM_TIMES):
        assert 0.0 < chute.min_gap(f["pos"]) < 0.05
        assert float(f["pos"][:, 2].min()) > 1.0      # over the ground
    # the solid fraction of the bed's layered lattice
    frac = (4.0 / 3.0 * np.pi) / (chute.A_XY ** 2 * np.sqrt(3) / 2
                                  * chute.A_Z)
    assert 0.55 <= frac <= 0.6


def test_chute_reuses_the_pile_shapes_and_times():
    assert chute.ANIM_TIMES == pile.ANIM_TIMES
    assert chute.ANIM_FPS == pile.ANIM_FPS
    for (a, _), (b, _) in zip(chute.library_shapes(), pile.library_shapes()):
        np.testing.assert_array_equal(a, b)
    eye = np.asarray(chute.TIME_EYE)
    assert abs(np.linalg.norm(chute.camera_target() - eye)
               - chute.TIME_FOCAL) < 1e-9


def rehearse(seed, size=TINY_CHUTE, device="cpu"):
    run = chute_stream.Run(harness.config("dem_chute"),
                           harness.traffic("chute_whitted_stream"), seed,
                           device, size=size)
    run.setup()
    stats = run.window(0.0)
    run.release()
    return run, stats


def correct(run, stats, cell, numbers=None):
    numbers = run.check() if numbers is None else numbers
    return harness.judge(cell, numbers, stats["attempted"],
                         stats["failed"])[0]


def test_chute_cell_rehearses_correct():
    run, stats = rehearse(3_000_000_019)
    assert stats["attempted"] == 4 and stats["failed"] == 0
    numbers = run.check()
    assert numbers["schedule"] == 0 and numbers["unchecked"] == 0
    assert correct(run, stats, "chute_whitted_anim", numbers), numbers
    # the check looked from the chute's camera, then gave the pile's back
    assert time_stream.gen is pile


def test_chute_control_comes_out_not_correct():
    run, stats = rehearse(2_147_483_693)
    readings = run.control()
    low = {k.split(".", 1)[1]: v for k, v in readings.items()
           if k.startswith("program.")}
    high = {k.split(".", 1)[1]: v for k, v in readings.items()
            if k.startswith("control.")}
    assert correct(run, stats, "chute_whitted_anim", low)
    assert not correct(run, stats, "chute_whitted_anim", high)


def test_chute_fault_comes_out_not_correct(monkeypatch):
    """A program whose temporal history never moves."""
    from optix_ray_tracer_tpu_torch.render import temporal
    monkeypatch.setattr(temporal, "temporal_blend",
                        lambda state, irr, *a, **k: (irr, state))
    run, stats = rehearse(2_147_483_671)
    assert not correct(run, stats, "chute_whitted_anim")


def test_chute_camera_is_the_chutes():
    """The program and the check see the bed from the chute's camera: a
    check from the pile's camera reads the frames as wrong."""
    run, stats = rehearse(2_147_483_659)
    assert correct(run, stats, "chute_whitted_anim")
    wrong = time_stream.Run.compare(run, torch.float32)
    assert not correct(run, stats, "chute_whitted_anim", wrong)


def test_pile_path_overflow_rehearses_correct():
    run = time_stream.Run(harness.config("dem_pile"),
                          harness.traffic("path_overflow_stream"),
                          2_147_483_659, "cpu",
                          size=dict(width=48, height=32, particles=48))
    run.setup()
    stats = run.window(0.0)
    run.release()
    assert run.panel[0][2][0] == 12.0 and run.panel[0][0][2] == 30.0
    assert correct(run, stats, "pile_path_overflow")


@pytest.mark.cuda
def test_chute_on_the_card(card):
    """The chute at 320x240 with 2,048 particles on the card: the program
    passes its limits, the control does not."""
    run, stats = rehearse(3_000_000_019, dict(width=320, height=240,
                                              particles=2048), card)
    readings = run.control()
    lim = harness.limits("chute_whitted_anim")
    for k in ("frame_px_share", "history_share"):
        assert readings[f"program.{k}"] <= lim[k]
    assert any(readings[f"control.{k}"] > lim[k]
               for k in ("frame_px_share", "history_share"))


def _trace(events, units=2):
    return harness.Trace(events, window_s=1.0, units=units)


def _ev(name, ts, dur, cat="kernel"):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def _read(name, trace, stats=None):
    return harness.metric_reader(name)(dict(stats=stats or {}, trace=trace))


DEEP_MARCH = "void (anonymous namespace)::deep_warp_march_kernel<false>()"
DEEP_PROBE = "(anonymous namespace)::deep_probe_kernel(float const*)"


def test_chute_metrics_read_the_deep_kernels_and_span():
    """Two frames of F2, C2 and B launches under ``march.deep`` spans:
    the deep kernels count in ``deep_cull_ms`` and in ``marcher_ms`` (its
    frozen names match theirs), not in ``torch_ms``; the span counts per
    frame; each roofline share is the floor's time over the launches'."""
    ev = [_ev(DEEP_MARCH, 0.0, 4000.0), _ev(DEEP_PROBE, 5000.0, 2000.0),
          _ev("void (anonymous namespace)::warp_march_kernel<false, "
              "false, true>()", 8000.0, 1000.0),
          _ev("void at::native::elementwise_kernel<128, 2>()", 9000.0,
              500.0)]
    ev += [_ev("march.deep", t, 100.0, "user_annotation")
           for t in (0.0, 10.0, 20.0, 30.0)]
    tr = _trace(ev)
    assert _read("deep_cull_ms.chute", tr) == pytest.approx(3.0)
    assert _read("marcher_ms.chute", tr) == pytest.approx(3.5)
    assert _read("torch_ms.chute", tr) == pytest.approx(0.25)
    assert _read("deep_waves_per_frame.chute", tr) == 2.0
    from portbench import roofline
    # the chute's camera wave (every ray live) and a bounce wave with a
    # quarter of its rays live, over the chute's 26,132 clusters
    march = [(960000, 960000, 26132), (960000, 240000, 26132)]
    probe = [(960000, 240000, 26132)]
    stats = {"deep_waves": {"deep_warp_march_kernel": march,
                            "deep_probe_kernel": probe}}
    top = 409                  # ceil(ceil(26132 / 8) / 8) hyperclusters
    assert roofline.hyperclusters(26132) == top
    cam_ops = 960000 * top * 26 / 67e12
    bounce_ops = 240000 * top * 26 / 67e12
    assert roofline.floor_s("deep_warp_march_kernel", *march[0]) == \
        pytest.approx(cam_ops)
    assert roofline.floor_s("deep_warp_march_kernel", *march[1]) == \
        pytest.approx(bounce_ops)
    # a wave of dead rays is bound by its bytes: bounds read, answer
    # written, the hypercluster table read once
    assert roofline.floor_s("deep_probe_kernel", 960000, 0, 26132) == \
        pytest.approx((960000 * 12 + top * 32) / 3.35e12)
    assert roofline.floor_s("deep_warp_march_kernel", 960000, 0, 26132) \
        == pytest.approx((960000 * 16 + top * 32) / 3.35e12)
    # one F2 launch of 4 ms and one C2 launch of 2 ms in the trace: each
    # share is the recorded waves' mean floor over the mean launch
    assert _read("deep_warp_march_roofline_pct.chute", tr, stats) == \
        pytest.approx(100.0 * (cam_ops + bounce_ops) / 2 / 4e-3)
    assert _read("deep_probe_roofline_pct.chute", tr, stats) == \
        pytest.approx(100.0 * bounce_ops / 2e-3)
    # without recorded waves (another driver) the shares read None
    assert _read("deep_warp_march_roofline_pct.chute", tr) is None


def test_chute_window_records_the_deep_waves(monkeypatch):
    """While a profiler traces the window, ``chute_stream`` records each
    F2 call and each C2 probe (past MAX_CLUSTERS) as (rays, live rays,
    clusters) and gives the program its functions back; an untraced
    window records nothing."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    calls = []

    def march(rays, n_clusters, **kw):
        calls.append(("F2", n_clusters))

    def probe(rays, boxes, n_clusters, c_pad, sup_boxes=None,
              hyper_boxes=None):
        calls.append(("C", n_clusters))

    r = torch.zeros(8, 64)
    r[7] = 1.0
    r[7, :16] = 0.0               # t_max = t_min: dead
    r[0, 16] = float("nan")       # a NaN origin: no test needed
    r[4, 17] = float("inf")       # an infinite direction: likewise

    def window(self, seconds, max_units=None):
        bm.march_deep_call(rays=r, n_clusters=9000, any_hit=False)
        bm.probe_call(r, None, 9000, 9000)
        bm.probe_call(r, None, 3368, 3368)     # C, not C2: not recorded
        return dict(units=1)

    monkeypatch.setattr(bm, "march_deep_call", march)
    monkeypatch.setattr(bm, "probe_call", probe)
    monkeypatch.setattr(time_stream.Run, "window", window)
    run = chute_stream.Run.__new__(chute_stream.Run)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        stats = run.window(1.0)
    assert stats["deep_waves"] == {
        "deep_warp_march_kernel": [(64, 46, 9000)],
        "deep_probe_kernel": [(64, 46, 9000)]}
    assert calls == [("F2", 9000), ("C", 9000), ("C", 3368)]
    assert bm.march_deep_call is march and bm.probe_call is probe
    assert "deep_waves" not in run.window(1.0)


def test_chute_metrics_read_none_without_the_deep_route():
    """The parent's trace: no F2, C2 or ``march.deep``; every new reader
    gives None, never 0."""
    tr = _trace([_ev("void (anonymous namespace)::warp_march_kernel<false, "
                     "false, false>()", 0.0, 100.0)])
    for name in ("deep_cull_ms.chute", "deep_waves_per_frame.chute",
                 "deep_warp_march_roofline_pct.chute",
                 "deep_probe_roofline_pct.chute"):
        assert _read(name, tr) is None
        assert _read(name, None) is None

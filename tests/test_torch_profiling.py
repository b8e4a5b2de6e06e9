"""The port's spans (``utils/profiling.span``): a shared null context
while no profiler records; ``user_annotation`` events that nest under a
profiler; the fused frame loop's phase spans, one per file, chunk or
frame, none overlapping another and none open while the consumer works;
the raster routes' spans on an overflowing schedule; and, on the card,
a sync span's end on the clock of the kernel it waited for."""

import json

import pytest
import torch

import chip_smoke as cs
from optix_ray_tracer_tpu_torch.io import config as tconfig
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.models import renderer_time as ttime
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.utils import profiling

torch.set_num_threads(2)

PHASES = ("fused.file", "fused.chunk", "fused.deliver")


def _annotations(prof, tmp_path) -> list:
    """(name, start us, end us) of each host span of the profile."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"),
                  key=lambda x: x[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _overlap(a, b) -> bool:
    return max(a[1], b[1]) < min(a[2], b[2])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_is_the_shared_null_context_without_a_profiler():
    a, b = profiling.span("fused.file"), profiling.span("sync.fetch")
    assert a is b
    with a:
        pass
    assert not isinstance(a, torch.profiler.record_function)


def test_span_records_nested_user_annotations(tmp_path):
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            assert isinstance(profiling.span("x"),
                              torch.profiler.record_function)
            with profiling.span("inner"):
                torch.ones(4).sum()
    spans = _annotations(prof, tmp_path)
    (outer,), (inner,) = _named(spans, "outer"), _named(spans, "inner")
    assert _inside(inner, outer)
    assert profiling.span("after") is profiling.span("again")


@pytest.fixture(scope="module")
def small_time(tmp_path_factory):
    """A committed Time series: 6 particles of three small shapes, 2
    files of 2 frames, 32x24, one chunk a file."""
    root = tmp_path_factory.mktemp("time")
    times = cs.ANIM_TIMES[:2]
    poses = cs.pile_poses(6, times)
    for p in poses:
        p["pos"] = p["pos"] * 0.12
        p["vel"] = p["vel"] * 0.12
    series, stl = cs.write_time_series(
        root / "time", [sphere_with_n_triangles(s) for s in (40, 80, 120)],
        poses, times)
    cfg = json.loads(cs.write_anim_config(
        root / "time.json", series, stl, root / "cache", 32, 24, 8
    ).read_text())
    cfg["loop-data"].update({"camera-center": [6.0, 1.0, 2.0],
                             "camera-target": [0.0, 0.0, -0.5]})
    return ttime.commit(tconfig.parse_config_dict(cfg, base_dir=str(root)),
                        device="cpu")


def test_fused_loop_phase_spans(small_time, tmp_path):
    data = small_time
    assert data.file_count == 2
    got = []
    with _cpu_profile() as prof:
        gen = ttime.render_frames(data, loop=False, quantize=True)
        while True:
            try:
                fi, k, frame = next(gen)
            except StopIteration:
                break
            with torch.profiler.record_function("consumer"):
                got.append((fi, k, frame.to_uint8().sum()))
    assert [(fi, k) for fi, k, _ in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    spans = _annotations(prof, tmp_path)
    files, chunks, delivers = (_named(spans, n) for n in PHASES)
    frames = _named(spans, "fused.frame")
    assert len(files) == 2 and len(chunks) == 2 and len(delivers) == 2
    assert len(frames) == 4
    assert len(_named(spans, "fused.rebuild")) == 2
    for part in ("fused.refit", "fused.trace", "fused.tail"):
        assert len(_named(spans, part)) == 4
        for s in _named(spans, part):
            assert any(_inside(s, f) for f in frames), part
    for f in frames:
        assert sum(_inside(f, c) for c in chunks) == 1
    phases = [s for s in spans if s[0] in PHASES]
    for i, a in enumerate(phases):
        for b in phases[i + 1:]:
            assert not _overlap(a, b), (a, b)
    consumer = _named(spans, "consumer")
    assert len(consumer) == 4
    for c in consumer:
        for s in spans:
            if s[0].startswith("fused."):
                assert not _overlap(c, s), (c, s)


def test_overflowing_raster_waves_take_the_marcher(tmp_path):
    v, n = sphere_with_n_triangles(600)
    scene = Scene(Spheres.empty(device="cpu"),
                  Triangles.from_arrays(v, n, device="cpu"))
    inter = make_march_intersector(scene, raster=True)
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device="cpu")
    o, d = cam.generate_rays(32, 32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    want = inter.intersect(scene, o, d)
    with _cpu_profile() as prof:
        a = inter.intersect_from(scene, o, d, mode="origin",
                                 point=cam.center, pc_max=1)
        b = inter.intersect_bundled(scene, o, d, pc_max=1)
    for hit in (a, b):
        assert torch.equal(hit.is_hit, want.is_hit)
    spans = _annotations(prof, tmp_path)
    waves = _named(spans, "route.raster")
    assert len(waves) == 2
    assert len(_named(spans, "route.overflow")) == 2
    counts = _named(spans, "sync.pair_count")
    assert len(counts) == 2
    for w, c in zip(waves, counts):
        assert _inside(c, w)


@pytest.mark.cuda
def test_sync_span_ends_with_the_kernel_it_waits_for(tmp_path):
    """A ~2 ms kernel queued, then a sync span around the wait for it: on
    the trace's one clock the kernel ends inside the span and the span
    ends within 0.2 ms of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cycles = 4_000_000                # ~2 ms at the H100's 1.98 GHz
    torch.cuda._sleep(cycles // 10)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("sync.warm"):
            torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        with profiling.span("sync.test"):
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (kernel,) = [e for e in events if e.get("cat") == "kernel"]
    (span,) = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "sync.test"]
    launch = [e for e in events if e.get("cat") == "cuda_runtime"
              and "Launch" in e["name"]]
    k_start, k_end = float(kernel["ts"]), float(kernel["ts"]) + kernel["dur"]
    s_start, s_end = float(span["ts"]), float(span["ts"]) + span["dur"]
    where = (f"launch {[float(e['ts']) for e in launch]}, kernel "
             f"{k_start}-{k_end}, span {s_start}-{s_end} (us)")
    assert s_start < k_end <= s_end, where
    assert s_end - k_end <= 200.0, where

"""The frozen copies give the scenes that chip_smoke.py gives, so the
cells are the scenes the port's earlier measurements ran."""

import numpy as np

import chip_smoke
from portbench.gen import pile


def test_pile_constants():
    assert pile.N_PARTICLES == chip_smoke.N_PARTICLES
    assert pile.TIME_LIBRARY == chip_smoke.TIME_LIBRARY
    assert pile.ANIM_TIMES == chip_smoke.ANIM_TIMES
    assert pile.ANIM_FPS == chip_smoke.ANIM_FPS
    assert pile.TIME_EYE == chip_smoke.TIME_EYE
    assert pile.TIME_FOCAL == chip_smoke.TIME_FOCAL
    assert pile.light_corners(*chip_smoke.ANIM_LIGHT[:2])[2][0] == \
        chip_smoke.ANIM_LIGHT[1]


def test_pile_poses_equal_chip_smoke_at_its_seed():
    want = chip_smoke.pile_poses(chip_smoke.N_PARTICLES, chip_smoke.ANIM_TIMES)
    got = pile.pile_poses(pile.N_PARTICLES, pile.ANIM_TIMES, seed=7)
    for a, b in zip(got, want):
        for k in ("pos", "quat", "vel", "sid", "ids"):
            np.testing.assert_array_equal(a[k], b[k])


def test_pile_shapes_equal_the_port_meshgen():
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    for (v, n), s in zip(pile.library_shapes(), pile.TIME_LIBRARY):
        v2, n2 = sphere_with_n_triangles(s)
        np.testing.assert_array_equal(v, v2)
        np.testing.assert_array_equal(n, n2)
    assert [len(v) for v, _ in pile.library_shapes()] == [60, 168, 396]


def test_series_files_read_back_as_written(tmp_path):
    from optix_ray_tracer_tpu_torch.io.vtk import read_time_file
    poses = pile.pile_poses(50, pile.ANIM_TIMES, seed=3)
    series, stl = pile.write_time_series(tmp_path, pile.library_shapes(),
                                         poses, pile.ANIM_TIMES)
    want = tmp_path / "ref"
    want.mkdir()
    chip_smoke.write_time_series(want, [pile.sphere_with_n_triangles(s)
                                        for s in pile.TIME_LIBRARY],
                                 poses, pile.ANIM_TIMES)
    for f in range(len(poses)):
        a = read_time_file(tmp_path / f"pose{f}.vtk")
        b = read_time_file(want / f"pose{f}.vtk")
        for k in ("positions", "ids", "quats", "velocities", "shape_ids"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    for p in sorted(stl.iterdir()):
        assert p.read_bytes() == (want / "shapes" / p.name).read_bytes()
    assert series.read_text() == (want / "pile.vtk.series").read_text()

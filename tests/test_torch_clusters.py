"""The port's host cluster build gives arrays identical to the JAX
package's build_clusters (same numpy SAH in float64, same layouts, NaN
padding boxes in the same places), and convert.py carries the JAX arrays
over unchanged."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import sweep as tsweep

torch.set_num_threads(1)


def _tris(n_tri, with_quad):
    v, _ = sphere_with_n_triangles(n_tri)
    if with_quad:
        qv, _ = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
        v = np.concatenate([v, qv])
    return v


@pytest.mark.parametrize("method", ["sah", "morton"])
@pytest.mark.parametrize("n_tri,with_quad", [(60, False), (700, False),
                                             (2500, True)])
def test_build_clusters_identical(n_tri, with_quad, method):
    v = _tris(n_tri, with_quad)
    ref = convert.state_arrays(jsweep.build_clusters(v, method=method))
    got = tsweep.build_clusters(v, method=method, device="cpu")
    for name in convert.CLUSTER_FIELDS:
        a = getattr(got, name).numpy()
        assert a.dtype == ref[name].dtype, name
        np.testing.assert_array_equal(a, ref[name], err_msg=name)
    # padding clusters / sub boxes are NaN in both
    assert np.isnan(ref["sub_min"]).any() == (v.shape[0] % 64 != 0)


def test_convert_roundtrip():
    v = _tris(700, False)
    ref = convert.state_arrays(jsweep.build_clusters(v))
    cs = convert.clusters(ref, device="cpu")
    assert cs.num_clusters == ref["cluster_min"].shape[0]
    for name in convert.CLUSTER_FIELDS:
        np.testing.assert_array_equal(getattr(cs, name).numpy(), ref[name])
    assert cs.woop_t.shape == (cs.num_clusters, 16, tsweep.CHUNK)

"""``block_march.needed_work``, the work a wave's answers require of an
exact marcher (the yardstick of kernels B, E and F's bounds), on the
small flat scene of tests/test_torch_block_march.py (kernels B and F)
and the small TLAS of tests/test_torch_instanced.py (kernel E):

* it equals a brute-force loop over each ray's cull rows (or
  superclusters, then their clusters) and parts, with the rule written
  out: a box is needed when the ray enters it before its t_max on a miss,
  at or before its t on a hit;
* it is never larger than the work the plain versions actually do on the
  same nearest-hit wave (their slab tests, ray transforms and Woop tests,
  counted as they run).

Counts are integers and compared exactly."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from test_torch_block_march import setup  # noqa: F401  (fixture)
from test_torch_instanced import _setup, _waves

torch.set_num_threads(2)

N_RAYS = 96


@pytest.fixture(scope="module")
def tlas():
    return _setup(12, 1.0, 3, invalid=(5,))


def _rays(o, d, dead: bool = True):
    """The first N_RAYS rays, every fifth dead (t_max 0)."""
    o, d = (torch.as_tensor(np.array(x[:N_RAYS])) for x in (o, d))
    tmax = torch.full((N_RAYS,), 1e16)
    if dead:
        tmax[::5] = 0.0
    return o, d, torch.full((N_RAYS,), 1e-3), tmax


def _case(name, setup, tlas):
    """(plain function, its arguments, needed_work's keyword arguments)."""
    if name == "tlas":
        inter = tlas["tinter"]
        o, d = _waves(tlas)
        idx = np.linspace(0, len(o) - 1, N_RAYS).round().astype(int)
        inp = bm.march_instanced_inputs(
            inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
            inter.pair_shape, inter.pair_inst, inter.inst_rows,
            inter.library.woop_t, *_rays(o[idx], d[idx]))
        args = {k: v for k, v in inp.items() if k != "w"}
        return bm.march_instanced_plain, args, dict(
            n_rows=inp["n_pairs"], n_subs=inp["sub_boxes"].shape[1],
            instanced=True)
    _, tc, _, waves = setup
    coherent = name != "flat-incoherent"
    o, d = waves["coherent" if coherent else "incoherent"]
    if name == "hier":
        inp = bm.hier_inputs(tc, *_rays(o, d), coherent=True)
        args = {k: v for k, v in inp.items() if k != "w"}
        return bm.march_hier_plain, args, dict(
            n_rows=inp["n_clusters"], n_subs=inp["n_subs"],
            sup_boxes=inp["sup_boxes"])
    inp = bm.march_inputs(tc, *_rays(o, d), coherent=coherent,
                          block_rays=32)
    args = {k: v for k, v in inp.items() if k != "w"}
    return bm.march_plain, args, dict(n_rows=inp["n_clusters"],
                                      n_subs=inp["n_subs"])


def _brute(rays, t, slot, boxes, sub_boxes, n_rows, n_subs,
           instanced=False, sup_boxes=None):
    """needed_work's counts by a loop over rays, boxes and parts."""
    work = dict(slab=0, inst=0, woop=0)
    for r in range(rays.shape[1]):
        o, inv, tmin = rays[0:3, r], bm.inv_dir(rays[3:6, r]), rays[6, r]
        hit = bool(slot[r] >= 0)

        def needs(box):
            e = bm.slab_entry(box[0:3], box[3:6], o, inv, tmin)
            return bool(e <= t[r]) if hit else bool(e < rays[7, r])

        if sup_boxes is None:
            work["slab"] += n_rows
        else:
            n_sup = -(-n_rows // bm.GROUP)
            work["slab"] += n_sup
            for s in range(n_sup):
                if needs(sup_boxes[s]):
                    work["slab"] += min(bm.GROUP, n_rows - bm.GROUP * s)
        for c in range(n_rows):
            if not needs(boxes[c]):
                continue
            work["slab"] += n_subs
            parts = sum(needs(sub_boxes[c, p]) for p in range(n_subs))
            work["woop"] += parts * (bm.CLUSTER_TRIS // n_subs)
            work["inst"] += int(instanced and parts > 0)
    return work


CASES = ["flat-coherent", "flat-incoherent", "hier", "tlas"]


@pytest.mark.parametrize("name", CASES)
def test_needed_work_matches_brute_force(setup, tlas, name):  # noqa: F811
    fn, args, kw = _case(name, setup, tlas)
    t, slot = fn(**args, any_hit=False)
    got = bm.needed_work(args["rays"], t, slot, args["boxes"],
                         args["sub_boxes"], **kw)
    want = _brute(args["rays"], t, slot, args["boxes"], args["sub_boxes"],
                  **kw)
    assert got == want
    assert got["woop"] > 0
    assert (got["inst"] > 0) == (name == "tlas")


@pytest.mark.parametrize("name", CASES)
def test_needed_work_at_most_plain(setup, tlas, name,  # noqa: F811
                                   monkeypatch):
    """The plain versions' own slab tests, ray transforms and Woop tests,
    counted by wrapping the functions they call, bound needed_work."""
    fn, args, kw = _case(name, setup, tlas)
    ran = dict(slab=0, inst=0, woop=0)

    def counting(key, real, size):
        def wrapped(*a):
            out = real(*a)
            ran[key] += size(a, out)
            return out
        return wrapped

    monkeypatch.setattr(bm, "slab_entry", counting(
        "slab", bm.slab_entry, lambda a, out: out.numel()))
    monkeypatch.setattr(bm, "woop_dots", counting(
        "woop", bm.woop_dots, lambda a, out: out[0].numel()))
    monkeypatch.setattr(bm, "instance_points", counting(
        "inst", bm.instance_points, lambda a, out: out.shape[0]))
    t, slot = fn(**args, any_hit=False)
    monkeypatch.undo()
    need = bm.needed_work(args["rays"], t, slot, args["boxes"],
                          args["sub_boxes"], **kw)
    assert all(need[k] <= ran[k] for k in ran), (need, ran)
    assert need["woop"] > 0

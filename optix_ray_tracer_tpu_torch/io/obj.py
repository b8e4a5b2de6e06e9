"""Wavefront OBJ loader (benchmark configs 3/5: bunny / Sponza-class).

Supports v / vn / vt / f (triangulating polygon faces as fans), groups and
usemtl tags for per-face material assignment, and a companion .mtl parser
(Kd diffuse / Ks+Ns crude metal mapping / map_Kd texture name passthrough).
Pure Python, dependency-free.

A copy of ``optix_ray_tracer_tpu/io/obj.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    vertices: np.ndarray      # (T, 3, 3) float32
    normals: np.ndarray       # (T, 3, 3) float32 (smooth or from face)
    uvs: np.ndarray           # (T, 3, 2) float32 (0 where absent)
    material_names: list[str]  # per-triangle material name ("" if none)

    @property
    def triangle_count(self) -> int:
        return len(self.vertices)


def read_obj(path: str) -> ObjMesh:
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    uvs: list[list[float]] = []
    tri_idx: list[tuple] = []   # ((vi, ti, ni) x3, material)
    current_mtl = ""

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif tag == "vt":
                uvs.append([float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag == "usemtl":
                current_mtl = parts[1] if len(parts) > 1 else ""
            elif tag == "f":
                corners = []
                for spec in parts[1:]:
                    comp = spec.split("/")
                    vi = int(comp[0])
                    ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                    ni = int(comp[2]) if len(comp) > 2 and comp[2] else 0
                    corners.append((vi, ti, ni))
                # fan triangulation
                for k in range(1, len(corners) - 1):
                    tri_idx.append((corners[0], corners[k], corners[k + 1],
                                    current_mtl))

    np_pos = np.asarray(positions, np.float32) if positions \
        else np.zeros((0, 3), np.float32)
    np_nrm = np.asarray(normals, np.float32) if normals \
        else np.zeros((0, 3), np.float32)
    np_uv = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)

    def resolve(idx, count):
        # OBJ indices are 1-based; negative = relative from end
        return idx - 1 if idx > 0 else count + idx

    T = len(tri_idx)
    v_out = np.zeros((T, 3, 3), np.float32)
    n_out = np.zeros((T, 3, 3), np.float32)
    uv_out = np.zeros((T, 3, 2), np.float32)
    mtl_out: list[str] = []
    has_any_normals = len(np_nrm) > 0

    for t, (c0, c1, c2, mtl) in enumerate(tri_idx):
        for j, (vi, ti, ni) in enumerate((c0, c1, c2)):
            v_out[t, j] = np_pos[resolve(vi, len(np_pos))]
            if ti:
                uv_out[t, j] = np_uv[resolve(ti, len(np_uv))]
            if ni and has_any_normals:
                n_out[t, j] = np_nrm[resolve(ni, len(np_nrm))]
        mtl_out.append(mtl)

    # faces without normals: geometric face normal
    missing = (np.abs(n_out).sum(axis=(1, 2)) == 0)
    if missing.any():
        e1 = v_out[missing, 1] - v_out[missing, 0]
        e2 = v_out[missing, 2] - v_out[missing, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
        n_out[missing] = fn[:, None, :]

    return ObjMesh(vertices=v_out, normals=n_out, uvs=uv_out,
                   material_names=mtl_out)


@dataclasses.dataclass
class MtlDef:
    name: str
    kd: tuple = (0.8, 0.8, 0.8)
    ks: tuple = (0.0, 0.0, 0.0)
    ns: float = 0.0
    ke: tuple = (0.0, 0.0, 0.0)
    map_kd: str | None = None


def read_mtl(path: str) -> dict[str, MtlDef]:
    mats: dict[str, MtlDef] = {}
    cur: MtlDef | None = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0].lower()
            if tag == "newmtl":
                cur = MtlDef(name=parts[1])
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif tag == "kd":
                cur.kd = tuple(float(x) for x in parts[1:4])
            elif tag == "ks":
                cur.ks = tuple(float(x) for x in parts[1:4])
            elif tag == "ns":
                cur.ns = float(parts[1])
            elif tag == "ke":
                cur.ke = tuple(float(x) for x in parts[1:4])
            elif tag == "map_kd":
                cur.map_kd = parts[-1]
    return mats


def obj_to_scene(obj_path: str, default_albedo=(0.73, 0.73, 0.73),
                 device=None):
    """Load an OBJ (+ optional sibling .mtl) into (Triangles, MaterialTable).

    Materials map: Kd -> ROUGH albedo; Ks bright + high Ns -> METAL;
    Ke nonzero -> EMISSIVE.  Tensors on ``device`` (None: the card).
    """
    from optix_ray_tracer_tpu_torch.scene.geometry import Triangles
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mesh = read_obj(obj_path)
    mtl_path = os.path.splitext(obj_path)[0] + ".mtl"
    mtls = read_mtl(mtl_path) if os.path.exists(mtl_path) else {}

    mb = MaterialBuilder()
    default_id = mb.add_rough(default_albedo)
    name_to_id: dict[str, int] = {"": default_id}
    for name, m in mtls.items():
        if any(c > 0 for c in m.ke):
            name_to_id[name] = mb.add_emissive(m.ke)
        elif max(m.ks) > 0.5 and m.ns > 200:
            name_to_id[name] = mb.add_metal(m.ks, fuzz=max(0.0, 1.0 - m.ns / 1000))
        else:
            name_to_id[name] = mb.add_rough(m.kd)

    mat_ids = np.asarray([name_to_id.get(n, default_id)
                          for n in mesh.material_names], np.int32)
    tris = Triangles.from_arrays(mesh.vertices, mesh.normals, mat_ids,
                                 device=device)
    return tris, mb.build(device), mesh

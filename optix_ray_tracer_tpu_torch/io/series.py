""".vtk.series manifest parsing + STL shape-library loading.

Reproduces the reference series semantics:

* ``readSeriesFile`` (``src/Util/VTKMeshReader.cu:86-145``): a JSON manifest
  ``{"files": [{"name": ..., "time": ...}, ...]}``; each file's *duration*
  is the time delta to the next file, and the last file reuses the previous
  delta (so every animation segment has a length).
* ``readSTLFiles`` (``src/Util/VTKTimeReader.cu:90-124``): scan a directory
  for ``*.stl``, sort lexicographically — the sorted position IS the
  shape_id the VTK time files refer to.

A copy of ``optix_ray_tracer_tpu/io/series.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class SeriesManifest:
    paths: list[str]       # absolute file paths, manifest order
    times: list[float]     # raw time stamps
    durations: list[float]  # per-file animation durations (time deltas)

    @property
    def count(self) -> int:
        return len(self.paths)


def read_series(series_path: str, series_name: str | None = None) -> SeriesManifest:
    """Parse a ``.vtk.series`` manifest.

    ``series_path``/``series_name`` mirror the reference's split config keys
    (config.json ``series-path`` + ``series-name``); pass a single full path
    as ``series_path`` with ``series_name=None`` too.
    """
    full = os.path.join(series_path, series_name) if series_name else series_path
    base_dir = os.path.dirname(os.path.abspath(full))
    with open(full, "r") as f:
        manifest = json.load(f)
    if "files" not in manifest:
        raise ValueError(f"{full}: no 'files' array in series manifest")

    paths, times = [], []
    for entry in manifest["files"]:
        paths.append(os.path.join(base_dir, entry["name"]))
        times.append(float(entry["time"]))

    # durations = deltas to the next file; last file reuses the final delta
    # (VTKMeshReader.cu:118-139 computes duration[i] = time[i+1]-time[i]).
    durations: list[float] = []
    for i in range(len(times) - 1):
        durations.append(times[i + 1] - times[i])
    if len(times) >= 2:
        durations.append(durations[-1])
    elif len(times) == 1:
        durations.append(1.0)
    return SeriesManifest(paths=paths, times=times, durations=durations)


def load_stl_directory(stl_dir: str):
    """Load every ``*.stl`` in a directory, lexicographic order = shape_id.

    Returns list of (vertices (t,3,3) float32, normals (t,3,3) float32).
    """
    from optix_ray_tracer_tpu_torch.io.native_io import read_stl

    names = sorted(n for n in os.listdir(stl_dir) if n.lower().endswith(".stl"))
    if not names:
        raise FileNotFoundError(f"no .stl files in {stl_dir}")
    return [read_stl(os.path.join(stl_dir, n)) for n in names]

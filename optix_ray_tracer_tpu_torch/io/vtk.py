"""Pure-Python legacy-VTK POLYDATA parser (ASCII and BINARY).

Replaces the reference's VTK 9.5 dependency (``src/Util/VTKReaderImpl.cpp``,
a GCC-compiled TU deliberately isolated from nvcc).  The reference reads
files through vtkPolyDataReader, which accepts ASCII *and* binary legacy
payloads (``VTKReaderImpl.cpp:27-63``); both forms are supported here —
binary payloads are big-endian per the legacy spec.  We parse only what
the renderer consumes:

* Time mode (``readVTKTimeFile``, VTKReaderImpl.cpp:140-248): per-point
  position + POINT_DATA arrays ``id`` (int), ``quat`` (4 doubles, w-x-y-z),
  ``vel`` (VECTORS), ``shape_id`` (int).
* Mesh mode (``readVTKMeshFile``, VTKReaderImpl.cpp:27-137): TRIANGLE_STRIPS
  cells (one strip per particle) decoded to triangle lists with the
  odd-triangle winding flip (:97-110), CELL_DATA arrays ``id``/``vel``, and
  smooth per-point vertex normals (the vtkPolyDataNormals equivalent:
  area-weighted face-normal average, consistently oriented).

The grammar is token-based, so layout quirks (trailing spaces, multi-value
lines) don't matter.  Unknown arrays are parsed and kept in ``point_data`` /
``cell_data`` dicts — the reference documents many parsed-but-unused fields
(VTKReaderImpl.cpp:183-248).

A copy of ``optix_ray_tracer_tpu/io/vtk.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class VTKParseError(ValueError):
    """Analog of the reference's VTK_READER_ERROR_EXIT_CODE=-1 fail-fast
    (include/Util/VTKMeshReader.cuh:7) — raised instead of exiting."""


_DTYPES = {
    "bit": np.uint8, "unsigned_char": np.uint8, "char": np.int8,
    "unsigned_short": np.uint16, "short": np.int16,
    "unsigned_int": np.uint32, "int": np.int32,
    "unsigned_long": np.uint64, "long": np.int64,
    "float": np.float32, "double": np.float64,
}


@dataclasses.dataclass
class PolyData:
    points: np.ndarray                      # (N, 3) float64
    vertices: list[np.ndarray]              # per-cell point-id arrays
    lines: list[np.ndarray]
    polygons: list[np.ndarray]
    triangle_strips: list[np.ndarray]
    point_data: dict[str, np.ndarray]
    cell_data: dict[str, np.ndarray]

    @property
    def num_points(self) -> int:
        return len(self.points)

    @property
    def num_cells(self) -> int:
        return (len(self.vertices) + len(self.lines) + len(self.polygons)
                + len(self.triangle_strips))


class _Tokens:
    __slots__ = ("toks", "pos")

    def __init__(self, text: str):
        self.toks = text.split()
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        if self.pos >= len(self.toks):
            raise VTKParseError("unexpected end of file")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def take(self, n: int) -> list[str]:
        if self.pos + n > len(self.toks):
            raise VTKParseError("unexpected end of file")
        out = self.toks[self.pos:self.pos + n]
        self.pos += n
        return out

    def done(self) -> bool:
        return self.pos >= len(self.toks)


def _read_cells(tk: _Tokens) -> list[np.ndarray]:
    n_cells = int(tk.next())
    total = int(tk.next())
    vals = np.asarray(tk.take(total), dtype=np.int64)
    cells = []
    pos = 0
    for _ in range(n_cells):
        cnt = int(vals[pos])
        cells.append(vals[pos + 1: pos + 1 + cnt])
        pos += 1 + cnt
    if pos != total:
        raise VTKParseError("cell section size mismatch")
    return cells


def parse_polydata(text: str) -> PolyData:
    """Parse a legacy ASCII VTK POLYDATA payload."""
    # strip the 2 header/comment lines by finding the ASCII/DATASET markers
    lines = text.splitlines()
    if not lines or not lines[0].lstrip().startswith("# vtk DataFile"):
        raise VTKParseError("not a legacy VTK file")
    body = "\n".join(lines[2:])  # line 0 version, line 1 free comment
    tk = _Tokens(body)

    fmt = tk.next().upper()
    if fmt != "ASCII":
        raise VTKParseError(f"only ASCII supported, got {fmt}")
    if tk.next().upper() != "DATASET" or tk.next().upper() != "POLYDATA":
        raise VTKParseError("only DATASET POLYDATA supported")

    pd = PolyData(points=np.zeros((0, 3)), vertices=[], lines=[],
                  polygons=[], triangle_strips=[], point_data={}, cell_data={})
    attr_target: dict[str, np.ndarray] | None = None
    attr_count = 0

    while not tk.done():
        kw = tk.next().upper()
        if kw == "POINTS":
            n = int(tk.next())
            tk.next()  # dtype
            pd.points = np.asarray(tk.take(3 * n), np.float64).reshape(n, 3)
        elif kw == "VERTICES":
            pd.vertices = _read_cells(tk)
        elif kw == "LINES":
            pd.lines = _read_cells(tk)
        elif kw == "POLYGONS":
            pd.polygons = _read_cells(tk)
        elif kw == "TRIANGLE_STRIPS":
            pd.triangle_strips = _read_cells(tk)
        elif kw == "POINT_DATA":
            attr_count = int(tk.next())
            attr_target = pd.point_data
        elif kw == "CELL_DATA":
            attr_count = int(tk.next())
            attr_target = pd.cell_data
        elif kw == "SCALARS":
            if attr_target is None:
                raise VTKParseError("SCALARS outside POINT_DATA/CELL_DATA")
            name = tk.next()
            dtype = _DTYPES.get(tk.next().lower(), np.float64)
            ncomp = 1
            if tk.peek() is not None and tk.peek().isdigit():
                ncomp = int(tk.next())
            if tk.peek() is not None and tk.peek().upper() == "LOOKUP_TABLE":
                tk.next()
                tk.next()  # table name
            vals = np.asarray(tk.take(attr_count * ncomp), np.float64)
            arr = vals.reshape(attr_count, ncomp) if ncomp > 1 else vals
            attr_target[name] = arr.astype(dtype) if ncomp == 1 else arr
        elif kw == "VECTORS":
            if attr_target is None:
                raise VTKParseError("VECTORS outside POINT_DATA/CELL_DATA")
            name = tk.next()
            tk.next()  # dtype
            attr_target[name] = np.asarray(
                tk.take(attr_count * 3), np.float64).reshape(attr_count, 3)
        elif kw == "NORMALS":
            if attr_target is None:
                raise VTKParseError("NORMALS outside POINT_DATA/CELL_DATA")
            name = tk.next()
            tk.next()
            attr_target[name] = np.asarray(
                tk.take(attr_count * 3), np.float64).reshape(attr_count, 3)
        elif kw == "FIELD":
            tk.next()  # field name
            narrays = int(tk.next())
            for _ in range(narrays):
                name = tk.next()
                ncomp = int(tk.next())
                ntup = int(tk.next())
                tk.next()  # dtype
                vals = np.asarray(tk.take(ncomp * ntup), np.float64)
                if attr_target is not None:
                    attr_target[name] = vals.reshape(ntup, ncomp) \
                        if ncomp > 1 else vals
        elif kw == "LOOKUP_TABLE":
            tk.next()
            n = int(tk.next())
            tk.take(4 * n)
        elif kw == "METADATA":
            # VTK >= 8 writes an INFORMATION block; skip until a blank-ish
            # known keyword — simplest: skip "INFORMATION n" pairs
            if tk.peek() and tk.peek().upper() == "INFORMATION":
                tk.next()
                n_info = int(tk.next())
                for _ in range(n_info * 2):
                    if tk.peek() and tk.peek().upper() in ("NAME", "DATA"):
                        tk.next()
                        tk.next()
        else:
            raise VTKParseError(f"unsupported VTK section: {kw}")
    return pd


# ---------------------------------------------------------------------------
# Binary legacy payloads (big-endian, per the legacy-VTK spec)
# ---------------------------------------------------------------------------

class _BinCursor:
    """Byte cursor over a legacy BINARY file: ASCII section-header lines
    interleaved with raw big-endian payloads."""
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def line(self) -> str | None:
        """Next non-empty ASCII line (None at EOF)."""
        while self.pos < len(self.data):
            end = self.data.find(b"\n", self.pos)
            if end < 0:
                end = len(self.data)
            raw = self.data[self.pos:end]
            self.pos = end + 1
            text = raw.decode("ascii", errors="replace").strip()
            if text:
                return text
        return None

    def raw(self, count: int, dtype) -> np.ndarray:
        """``count`` big-endian values of ``dtype``; skips the trailing
        newline the legacy writer emits after every binary payload."""
        be = np.dtype(dtype).newbyteorder(">")
        nbytes = count * be.itemsize
        if self.pos + nbytes > len(self.data):
            raise VTKParseError("unexpected end of binary payload")
        arr = np.frombuffer(self.data, be, count, self.pos)
        self.pos += nbytes
        if self.pos < len(self.data) and self.data[self.pos:self.pos + 1] == b"\n":
            self.pos += 1
        return arr.astype(np.dtype(dtype))


def _read_cells_binary(cur: _BinCursor, header: list[str]) -> list[np.ndarray]:
    n_cells = int(header[1])
    total = int(header[2])
    vals = cur.raw(total, np.int32).astype(np.int64)
    cells = []
    pos = 0
    for _ in range(n_cells):
        cnt = int(vals[pos])
        cells.append(vals[pos + 1: pos + 1 + cnt])
        pos += 1 + cnt
    if pos != total:
        raise VTKParseError("cell section size mismatch")
    return cells


def parse_polydata_binary(data: bytes) -> PolyData:
    """Parse a legacy BINARY VTK POLYDATA payload (big-endian)."""
    cur = _BinCursor(data)
    first = cur.line() or ""
    if not first.startswith("# vtk DataFile"):
        raise VTKParseError("not a legacy VTK file")
    cur.line()  # free comment line
    fmt = (cur.line() or "").upper()
    if fmt != "BINARY":
        raise VTKParseError(f"expected BINARY, got {fmt}")
    ds = (cur.line() or "").upper().split()
    if ds[:2] != ["DATASET", "POLYDATA"]:
        raise VTKParseError("only DATASET POLYDATA supported")

    pd = PolyData(points=np.zeros((0, 3)), vertices=[], lines=[],
                  polygons=[], triangle_strips=[], point_data={}, cell_data={})
    attr_target: dict[str, np.ndarray] | None = None
    attr_count = 0

    while True:
        header = cur.line()
        if header is None:
            break
        parts = header.split()
        kw = parts[0].upper()
        if kw == "POINTS":
            n = int(parts[1])
            dtype = _DTYPES.get(parts[2].lower(), np.float64)
            pd.points = cur.raw(3 * n, dtype).astype(np.float64).reshape(n, 3)
        elif kw in ("VERTICES", "LINES", "POLYGONS", "TRIANGLE_STRIPS"):
            cells = _read_cells_binary(cur, parts)
            setattr(pd, kw.lower(), cells)
        elif kw == "POINT_DATA":
            attr_count = int(parts[1])
            attr_target = pd.point_data
        elif kw == "CELL_DATA":
            attr_count = int(parts[1])
            attr_target = pd.cell_data
        elif kw == "SCALARS":
            if attr_target is None:
                raise VTKParseError("SCALARS outside POINT_DATA/CELL_DATA")
            name = parts[1]
            dtype = _DTYPES.get(parts[2].lower(), np.float64)
            ncomp = int(parts[3]) if len(parts) > 3 else 1
            # the spec requires a LOOKUP_TABLE line before binary scalars
            save = cur.pos
            nxt = cur.line()
            if nxt is None or not nxt.upper().startswith("LOOKUP_TABLE"):
                cur.pos = save
            vals = cur.raw(attr_count * ncomp, dtype)
            if ncomp > 1:
                attr_target[name] = vals.astype(np.float64).reshape(
                    attr_count, ncomp)
            else:
                attr_target[name] = vals
        elif kw in ("VECTORS", "NORMALS"):
            if attr_target is None:
                raise VTKParseError(f"{kw} outside POINT_DATA/CELL_DATA")
            name = parts[1]
            dtype = _DTYPES.get(parts[2].lower(), np.float64)
            attr_target[name] = cur.raw(attr_count * 3, dtype).astype(
                np.float64).reshape(attr_count, 3)
        elif kw == "FIELD":
            narrays = int(parts[2])
            for _ in range(narrays):
                ah = (cur.line() or "").split()
                if len(ah) < 4:
                    raise VTKParseError("bad FIELD array header")
                name, ncomp, ntup = ah[0], int(ah[1]), int(ah[2])
                dtype = _DTYPES.get(ah[3].lower(), np.float64)
                vals = cur.raw(ncomp * ntup, dtype).astype(np.float64)
                if attr_target is not None:
                    attr_target[name] = vals.reshape(ntup, ncomp) \
                        if ncomp > 1 else vals
        elif kw == "LOOKUP_TABLE":
            n = int(parts[2])
            cur.raw(4 * n, np.uint8)
        elif kw == "METADATA":
            # skip INFORMATION blocks (ASCII even in binary files)
            pass
        elif kw in ("INFORMATION", "NAME", "DATA"):
            pass
        else:
            raise VTKParseError(f"unsupported VTK section: {kw}")
    return pd


def read_polydata(path) -> PolyData:
    """Read a legacy VTK POLYDATA file, ASCII or BINARY (auto-detected
    from the format line, like vtkPolyDataReader)."""
    with open(path, "rb") as f:
        data = f.read()
    # format marker is the 3rd line
    head = data.split(b"\n", 3)
    fmt = head[2].strip().upper() if len(head) > 2 else b""
    if fmt == b"BINARY":
        return parse_polydata_binary(data)
    return parse_polydata(data.decode("ascii", errors="replace"))


_DTYPE_NAMES = {np.dtype(v).name: k for k, v in _DTYPES.items()
                if k != "bit"}


def write_polydata(path, pd: PolyData, binary: bool = True,
                   comment: str = "optix_ray_tracer_tpu export") -> None:
    """Write a PolyData as a legacy VTK file (BINARY big-endian by default,
    ASCII otherwise).  Covers the sections the parsers read: POINTS (double),
    cell blocks, and SCALARS/VECTORS attribute arrays.  Exists so binary
    ingestion is round-trip testable without the VTK library."""
    out = bytearray()

    def text(s: str) -> None:
        out.extend(s.encode("ascii") + b"\n")

    def payload(arr: np.ndarray, dtype) -> None:
        if binary:
            out.extend(np.ascontiguousarray(
                arr, np.dtype(dtype).newbyteorder(">")).tobytes() + b"\n")
        else:
            flat = np.asarray(arr).reshape(-1)
            if np.issubdtype(np.dtype(dtype), np.integer):
                text(" ".join(str(int(v)) for v in flat))
            else:
                text(" ".join(repr(float(v)) for v in flat))

    text("# vtk DataFile Version 2.0")
    text(comment)
    text("BINARY" if binary else "ASCII")
    text("DATASET POLYDATA")
    text(f"POINTS {pd.num_points} double")
    payload(pd.points, np.float64)
    for kw in ("vertices", "lines", "polygons", "triangle_strips"):
        cells = getattr(pd, kw)
        if not cells:
            continue
        flat = np.concatenate(
            [np.concatenate(([len(c)], c)) for c in cells]).astype(np.int32)
        text(f"{kw.upper()} {len(cells)} {flat.size}")
        payload(flat, np.int32)

    for label, attrs, count in (("POINT_DATA", pd.point_data, pd.num_points),
                                ("CELL_DATA", pd.cell_data, pd.num_cells)):
        if not attrs:
            continue
        text(f"{label} {count}")
        for name, arr in attrs.items():
            arr = np.asarray(arr)
            if arr.ndim == 2 and arr.shape[1] == 3 and \
                    np.issubdtype(arr.dtype, np.floating):
                text(f"VECTORS {name} double")
                payload(arr, np.float64)
            elif arr.ndim == 2:
                text(f"SCALARS {name} double {arr.shape[1]}")
                text("LOOKUP_TABLE default")
                payload(arr, np.float64)
            else:
                tname = _DTYPE_NAMES.get(arr.dtype.name, "double")
                text(f"SCALARS {name} {tname}")
                text("LOOKUP_TABLE default")
                payload(arr, arr.dtype)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# Renderer-facing views
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TimeFrame:
    """One Time-mode file: particle poses (readVTKTimeFile parity)."""
    positions: np.ndarray   # (P, 3) float32
    ids: np.ndarray         # (P,)  int64
    quats: np.ndarray       # (P, 4) float32, (w, x, y, z)
    velocities: np.ndarray  # (P, 3) float32
    shape_ids: np.ndarray   # (P,)  int64


def read_time_file(path) -> TimeFrame:
    pd = read_polydata(path)
    if pd.num_points == 0:
        raise VTKParseError(f"{path}: no points")
    n = pd.num_points

    def get(name, default=None):
        if name in pd.point_data:
            return pd.point_data[name]
        if default is None:
            raise VTKParseError(f"{path}: missing point array '{name}'")
        return default

    ids = get("id", np.arange(n)).astype(np.int64)
    quats = get("quat", np.tile([1.0, 0, 0, 0], (n, 1))).astype(np.float32)
    vel = get("vel", np.zeros((n, 3))).astype(np.float32)
    shape_ids = get("shape_id", np.zeros(n)).astype(np.int64)
    return TimeFrame(positions=pd.points.astype(np.float32), ids=ids,
                     quats=quats.reshape(n, 4), velocities=vel.reshape(n, 3),
                     shape_ids=shape_ids)


@dataclasses.dataclass
class MeshFrame:
    """One Mesh-mode file: per-particle triangle soups (readVTKMeshFile
    parity — one TRIANGLE_STRIPS cell per particle)."""
    ids: np.ndarray                  # (P,) int64
    velocities: np.ndarray           # (P, 3) float32
    vertices: list[np.ndarray]       # per particle (t_i, 3, 3) float32
    normals: list[np.ndarray]        # per particle (t_i, 3, 3) float32


def smooth_point_normals(points: np.ndarray,
                         strips: list[np.ndarray]) -> np.ndarray:
    """Per-point normals: area-weighted average of adjacent face normals,
    globally oriented outward from the centroid (the practical equivalent of
    vtkPolyDataNormals with splitting off + auto-orient,
    VTKReaderImpl.cpp:53-63)."""
    acc = np.zeros_like(points)
    for strip in strips:
        for k in range(len(strip) - 2):
            i0, i1, i2 = strip[k], strip[k + 1], strip[k + 2]
            if k & 1:
                i1, i2 = i2, i1
            fn = np.cross(points[i1] - points[i0], points[i2] - points[i0])
            acc[i0] += fn
            acc[i1] += fn
            acc[i2] += fn
    norms = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = np.divide(acc, norms, out=np.zeros_like(acc), where=norms > 1e-30)
    # orient outward from centroid (auto-orient approximation)
    centroid = points.mean(axis=0)
    outward = points - centroid
    flip = (acc * outward).sum(-1, keepdims=True) < 0
    if flip.mean() > 0.5:  # majority vote for global consistency
        acc = -acc
    return acc


def read_mesh_file(path) -> MeshFrame:
    pd = read_polydata(path)
    if pd.num_points == 0:
        raise VTKParseError(f"{path}: no points")
    if not pd.triangle_strips:
        raise VTKParseError(
            f"{path}: mesh mode requires TRIANGLE_STRIPS cells "
            f"(reference exits on other cell types, VTKReaderImpl.cpp:72-75)")
    n_cells = len(pd.triangle_strips)
    if "id" not in pd.cell_data or "vel" not in pd.cell_data:
        raise VTKParseError(f"{path}: missing cell arrays id/vel")

    pts = pd.points.astype(np.float32)
    pnormals = smooth_point_normals(pts, pd.triangle_strips).astype(np.float32)

    verts_all, normals_all = [], []
    for strip in pd.triangle_strips:
        ntri = max(len(strip) - 2, 0)
        v = np.zeros((ntri, 3, 3), np.float32)
        nn = np.zeros((ntri, 3, 3), np.float32)
        for k in range(ntri):
            i0, i1, i2 = strip[k], strip[k + 1], strip[k + 2]
            if k & 1:  # odd-triangle winding flip (VTKReaderImpl.cpp:97-110)
                i1, i2 = i2, i1
            v[k] = pts[[i0, i1, i2]]
            nn[k] = pnormals[[i0, i1, i2]]
        verts_all.append(v)
        normals_all.append(nn)

    return MeshFrame(
        ids=pd.cell_data["id"].astype(np.int64).reshape(n_cells),
        velocities=pd.cell_data["vel"].astype(np.float32).reshape(n_cells, 3),
        vertices=verts_all, normals=normals_all)

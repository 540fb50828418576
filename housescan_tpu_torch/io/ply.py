"""Stanford .ply mesh/cloud reader and writer (host numpy).

A copy of ``housescan_tpu/io/ply.py``: ascii and binary_little_endian,
vertices with optional colors and normals, and triangle faces (the
marching-tetrahedra meshes); the bytes written are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np


class PlyFormatError(ValueError):
    pass


@dataclass
class Mesh:
    vertices: np.ndarray  # (N, 3) float32
    faces: Optional[np.ndarray] = None  # (F, 3) int32, or None for point clouds
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]
    normals: Optional[np.ndarray] = None  # (N, 3) float32

    def __len__(self) -> int:
        return len(self.vertices)


_PLY_TYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "<u1",
    "uint8": "<u1",
    "char": "<i1",
    "int8": "<i1",
    "ushort": "<u2",
    "uint16": "<u2",
    "short": "<i2",
    "int16": "<i2",
    "uint": "<u4",
    "uint32": "<u4",
    "int": "<i4",
    "int32": "<i4",
}


def load_ply(path: Union[str, Path]) -> Mesh:
    data = Path(path).read_bytes()
    if not data.startswith(b"ply"):
        raise PlyFormatError(f"{path} is not a PLY file")
    end = data.find(b"end_header\n")
    if end < 0:
        raise PlyFormatError("PLY header not terminated")
    header_text = data[: end].decode("ascii", errors="replace")
    payload = data[end + len(b"end_header\n") :]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str, Optional[Tuple[str, str]]]]]] = []
    for line in header_text.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                raise PlyFormatError("property before element in PLY header")
            if parts[1] == "list":
                elements[-1][2].append((parts[4], "list", (parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1], None))

    if fmt not in ("ascii", "binary_little_endian"):
        raise PlyFormatError(f"unsupported PLY format {fmt!r}")

    vertices = colors = normals = None
    faces = None

    if fmt == "ascii":
        tokens = payload.decode("ascii", errors="replace").split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                ncols = len(props)
                vals = np.array(tokens[ti : ti + count * ncols], dtype=np.float64).reshape(
                    count, ncols
                )
                ti += count * ncols
                vertices, colors, normals = _extract_vertex_props(vals, [p[0] for p in props])
            elif name == "face":
                rows = []
                for _ in range(count):
                    k = int(tokens[ti]); ti += 1
                    rows.append([int(tokens[ti + j]) for j in range(k)])
                    ti += k
                faces = _triangulate(rows)
            else:
                # skip unknown ascii element conservatively
                ncols = len(props)
                ti += count * ncols
    else:
        offset = 0
        for name, count, props in elements:
            if any(p[1] == "list" for p in props):
                if name != "face" or len(props) != 1:
                    raise PlyFormatError(
                        f"unsupported PLY list layout in element {name!r}"
                    )
                count_t, idx_t = props[0][2]
                rows = []
                cdt = np.dtype(_PLY_TYPES[count_t])
                idt = np.dtype(_PLY_TYPES[idx_t])
                for _ in range(count):
                    k = int(np.frombuffer(payload, cdt, 1, offset)[0])
                    offset += cdt.itemsize
                    idx = np.frombuffer(payload, idt, k, offset)
                    offset += k * idt.itemsize
                    rows.append(idx.tolist())
                faces = _triangulate(rows)
            else:
                dtype = np.dtype([(p[0], _PLY_TYPES[p[1]]) for p in props])
                rec = np.frombuffer(payload, dtype, count, offset)
                offset += count * dtype.itemsize
                if name == "vertex":
                    table = np.stack(
                        [rec[p[0]].astype(np.float64) for p in props], axis=1
                    )
                    vertices, colors, normals = _extract_vertex_props(
                        table, [p[0] for p in props]
                    )

    if vertices is None:
        raise PlyFormatError(f"PLY file {path} has no vertex element")
    return Mesh(vertices=vertices, faces=faces, colors=colors, normals=normals)


def _triangulate(rows: List[List[int]]) -> np.ndarray:
    tris = []
    for row in rows:
        for j in range(1, len(row) - 1):  # fan triangulation
            tris.append([row[0], row[j], row[j + 1]])
    return np.asarray(tris, np.int32) if tris else np.zeros((0, 3), np.int32)


def _extract_vertex_props(table: np.ndarray, names: List[str]):
    def col(n):
        return table[:, names.index(n)] if n in names else None

    vertices = np.stack([col("x"), col("y"), col("z")], axis=1).astype(np.float32)
    colors = None
    if all(n in names for n in ("red", "green", "blue")):
        colors = np.stack([col("red"), col("green"), col("blue")], axis=1).astype(np.float32)
        if colors.max(initial=0.0) > 1.0:
            colors = colors / 255.0
    normals = None
    if all(n in names for n in ("nx", "ny", "nz")):
        normals = np.stack([col("nx"), col("ny"), col("nz")], axis=1).astype(np.float32)
    return vertices, colors, normals


def save_ply(path: Union[str, Path], mesh: Union[Mesh, np.ndarray], binary: bool = True) -> None:
    """Write a Mesh (or a bare (N, 3) array as a point cloud) to .ply,
    Meshlab-compatible (the reference's final inspection target,
    ref README.md:17)."""
    if isinstance(mesh, np.ndarray):
        mesh = Mesh(vertices=np.asarray(mesh, np.float32))
    n = len(mesh)
    has_color = mesh.colors is not None
    has_normal = mesh.normals is not None
    has_faces = mesh.faces is not None and len(mesh.faces) > 0

    header = ["ply", f"format {'binary_little_endian' if binary else 'ascii'} 1.0"]
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if has_normal:
        header += ["property float nx", "property float ny", "property float nz"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if has_faces:
        header.append(f"element face {len(mesh.faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    vdtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_normal:
        vdtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_color:
        vdtype += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
    rec = np.empty(n, dtype=np.dtype(vdtype))
    rec["x"], rec["y"], rec["z"] = (
        mesh.vertices[:, 0],
        mesh.vertices[:, 1],
        mesh.vertices[:, 2],
    )
    if has_normal:
        rec["nx"], rec["ny"], rec["nz"] = (
            mesh.normals[:, 0],
            mesh.normals[:, 1],
            mesh.normals[:, 2],
        )
    if has_color:
        c = np.clip(mesh.colors * 255.0, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    path = Path(path)
    if binary:
        blob = bytearray("\n".join(header).encode("ascii") + b"\n")
        blob += rec.tobytes()
        if has_faces:
            faces = np.asarray(mesh.faces, np.int32)
            fdtype = np.dtype([("k", "<u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
            frec = np.empty(len(faces), fdtype)
            frec["k"] = 3
            frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
            blob += frec.tobytes()
        path.write_bytes(bytes(blob))
    else:
        lines = ["\n".join(header)]
        for i in range(n):
            parts = [f"{float(rec[f][i]):.9g}" for f in ("x", "y", "z")]
            if has_normal:
                parts += [f"{float(rec[f][i]):.9g}" for f in ("nx", "ny", "nz")]
            if has_color:
                parts += [str(int(rec[f][i])) for f in ("red", "green", "blue")]
            lines.append(" ".join(parts))
        if has_faces:
            for f in mesh.faces:
                lines.append(f"3 {int(f[0])} {int(f[1])} {int(f[2])}")
        path.write_text("\n".join(lines) + "\n")

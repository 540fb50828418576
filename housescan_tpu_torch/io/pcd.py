"""PCL .pcd point-cloud reader and writer (host numpy).

A copy of ``housescan_tpu/io/pcd.py``, byte-for-byte the same output, for
all three PCL DATA encodings: ``ascii``, ``binary`` and
``binary_compressed`` (LZF over the field-major plaintext; the codec is
``io/native.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from housescan_tpu_torch.io import native

_PCD_DTYPES = {
    ("F", 4): "<f4",
    ("F", 8): "<f8",
    ("U", 1): "<u1",
    ("U", 2): "<u2",
    ("U", 4): "<u4",
    ("I", 1): "<i1",
    ("I", 2): "<i2",
    ("I", 4): "<i4",
}


@dataclass
class PointCloud:
    """Host-side point cloud: positions plus optional per-point extras."""

    points: np.ndarray  # (N, 3) float32
    colors: Optional[np.ndarray] = None  # (N, 3) float32 in [0, 1]
    normals: Optional[np.ndarray] = None  # (N, 3) float32
    extra: Dict[str, np.ndarray] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.points)


class PcdFormatError(ValueError):
    pass


def _parse_header(data: bytes):
    lines = []
    pos = 0
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise PcdFormatError("unterminated PCD header")
        line = data[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if line.startswith("#") or not line:
            continue
        lines.append(line)
        if line.split()[0] == "DATA":
            break
        if len(lines) > 64:
            raise PcdFormatError("PCD header too long / DATA line missing")
    header = {}
    for line in lines:
        key, _, rest = line.partition(" ")
        header[key] = rest.split()
    return header, pos


def load_pcd(path: Union[str, Path]) -> PointCloud:
    """Load an ascii, binary or binary_compressed .pcd file into a
    PointCloud."""
    data = Path(path).read_bytes()
    header, payload_start = _parse_header(data)
    try:
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        mode = header["DATA"][0]
    except (KeyError, IndexError, ValueError) as e:
        raise PcdFormatError(f"malformed PCD header in {path}: {e}") from None

    np_fields = []
    for name, size, typ, count in zip(fields, sizes, types, counts):
        base = _PCD_DTYPES.get((typ, size))
        if base is None:
            raise PcdFormatError(f"unsupported PCD field type {typ}{size}")
        np_fields.append((name, base) if count == 1 else (name, base, (count,)))
    dtype = np.dtype(np_fields)

    if mode == "ascii":
        ncols = sum(counts)
        try:
            values = native.parse_ascii_floats(data[payload_start:], n_points * ncols)
        except ValueError as e:
            raise PcdFormatError(f"PCD ascii payload: {e}") from None
        table = values.astype(np.float64).reshape(n_points, ncols)
        rec = np.empty(n_points, dtype=dtype)
        col = 0
        for name, count in zip(fields, counts):
            chunk = table[:, col : col + count]
            rec[name] = chunk.reshape(rec[name].shape).astype(rec.dtype[name])
            col += count
    elif mode == "binary":
        need = n_points * dtype.itemsize
        payload = data[payload_start : payload_start + need]
        if len(payload) < need:
            raise PcdFormatError(
                f"PCD binary payload truncated: {len(payload)} bytes, expected {need}"
            )
        rec = np.frombuffer(payload, dtype=dtype, count=n_points)
    elif mode == "binary_compressed":
        # PCL layout: u32 compressed size, u32 uncompressed size, then an
        # LZF blob whose plaintext is field-major: all x's, then all y's, ...
        head = data[payload_start : payload_start + 8]
        if len(head) < 8:
            raise PcdFormatError("binary_compressed PCD missing size header")
        comp_size, uncomp_size = np.frombuffer(head, "<u4", 2)
        blob = data[payload_start + 8 : payload_start + 8 + int(comp_size)]
        if len(blob) < comp_size:
            raise PcdFormatError(
                f"binary_compressed payload truncated: {len(blob)} bytes, "
                f"expected {int(comp_size)}"
            )
        expect = n_points * dtype.itemsize
        if int(uncomp_size) != expect:
            raise PcdFormatError(
                f"binary_compressed size mismatch: header says "
                f"{int(uncomp_size)}, fields need {expect}"
            )
        try:
            raw = native.lzf_decompress(bytes(blob), int(uncomp_size))
        except ValueError as e:
            raise PcdFormatError(f"binary_compressed payload: {e}") from None
        rec = np.empty(n_points, dtype=dtype)
        off = 0
        for name, count, typ, size in zip(fields, counts, types, sizes):
            nbytes = count * size * n_points
            block = np.frombuffer(raw[off : off + nbytes], _PCD_DTYPES[(typ, size)])
            rec[name] = block.reshape(rec[name].shape, order="C")
            off += nbytes
    else:
        raise PcdFormatError(f"unknown PCD DATA mode {mode!r}")

    for axis in ("x", "y", "z"):
        if axis not in rec.dtype.names:
            raise PcdFormatError(f"PCD file {path} lacks field {axis!r}")
    points = np.stack(
        [rec["x"].astype(np.float32), rec["y"].astype(np.float32), rec["z"].astype(np.float32)],
        axis=1,
    )
    colors = None
    if "rgb" in rec.dtype.names:
        colors = _unpack_rgb(rec["rgb"])
    elif all(c in rec.dtype.names for c in ("r", "g", "b")):
        colors = np.stack([rec["r"], rec["g"], rec["b"]], axis=1).astype(np.float32) / 255.0
    normals = None
    if all(c in rec.dtype.names for c in ("normal_x", "normal_y", "normal_z")):
        normals = np.stack(
            [rec["normal_x"], rec["normal_y"], rec["normal_z"]], axis=1
        ).astype(np.float32)
    return PointCloud(points=points, colors=colors, normals=normals)


def _unpack_rgb(rgb_field: np.ndarray) -> np.ndarray:
    """PCL packs r, g, b bytes into one float (or uint) 'rgb' field."""
    if rgb_field.dtype.kind == "f":
        packed = rgb_field.astype(np.float32).view(np.uint32)
    else:
        packed = rgb_field.astype(np.uint32)
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return np.stack([r, g, b], axis=1).astype(np.float32) / 255.0


def save_pcd(
    path: Union[str, Path],
    cloud: Union[PointCloud, np.ndarray],
    binary: bool = True,
    compressed: bool = False,
) -> None:
    """Write a PointCloud (or raw (N, 3) array) as .pcd. ``compressed=True``
    writes PCL's ``binary_compressed`` encoding (LZF over the field-major
    plaintext)."""
    if isinstance(cloud, np.ndarray):
        cloud = PointCloud(points=np.asarray(cloud, np.float32))
    n = len(cloud)

    fields = ["x", "y", "z"]
    np_fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if cloud.colors is not None:
        fields.append("rgb")
        np_fields.append(("rgb", "<f4"))
    if cloud.normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
        np_fields += [("normal_x", "<f4"), ("normal_y", "<f4"), ("normal_z", "<f4")]

    rec = np.empty(n, dtype=np.dtype(np_fields))
    rec["x"], rec["y"], rec["z"] = cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2]
    if cloud.colors is not None:
        rgb255 = np.clip(cloud.colors * 255.0, 0, 255).astype(np.uint32)
        packed = (rgb255[:, 0] << 16) | (rgb255[:, 1] << 8) | rgb255[:, 2]
        rec["rgb"] = packed.view(np.float32)
    if cloud.normals is not None:
        rec["normal_x"], rec["normal_y"], rec["normal_z"] = (
            cloud.normals[:, 0],
            cloud.normals[:, 1],
            cloud.normals[:, 2],
        )

    sizes = " ".join("4" for _ in fields)
    types = " ".join("F" for _ in fields)
    counts = " ".join("1" for _ in fields)
    if compressed:
        mode = "binary_compressed"
    else:
        mode = "binary" if binary else "ascii"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {mode}\n"
    )
    path = Path(path)
    if compressed:
        soa = b"".join(np.ascontiguousarray(rec[name]).tobytes() for name in rec.dtype.names)
        blob = native.lzf_compress(soa)
        sizes_hdr = np.array([len(blob), len(soa)], "<u4").tobytes()
        path.write_bytes(header.encode("ascii") + sizes_hdr + blob)
    elif binary:
        path.write_bytes(header.encode("ascii") + rec.tobytes())
    else:
        rows = [" ".join(repr(float(rec[name][i])) for name in rec.dtype.names) for i in range(n)]
        path.write_text(header + "\n".join(rows) + "\n")

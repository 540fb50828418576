"""ctypes bindings for the native host helpers (``native/housescan_native.cpp``).

The port's copy of ``housescan_tpu/io/native.py``: ASCII float parsing,
uint16 depth decoding, the row-vector point transform and the LZF codec
of ``binary_compressed`` .pcd files, all on the host. The library builds
on first use from the repository's ``native/housescan_native.cpp`` with
``native/Makefile``'s flags into ``build/housescan_native/`` at the
repository root (git-ignored), named by a hash of the source and flags;
``native/`` itself belongs to the JAX package's build and is never
written. Without a C++ compiler every entry point takes its numpy or
pure-Python version (the same codec, byte for byte).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "housescan_native.cpp"
BUILD_DIR = _ROOT / "build" / "housescan_native"
# native/Makefile's CXXFLAGS.
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Path:
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode() + _SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libhousescan_native_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.parse_ascii_floats.restype = ctypes.c_size_t
        lib.parse_ascii_floats.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
        ]
        lib.decode_u16_depth.restype = None
        lib.decode_u16_depth.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
            ctypes.c_float,
            ctypes.c_int,
        ]
        lib.transform_points.restype = None
        lib.transform_points.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        for fn in ("lzf_decompress", "lzf_compress"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_size_t
            f.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_size_t,
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_ascii_floats(data: bytes, expected: int) -> np.ndarray:
    """Parse whitespace-separated floats ('#' comments skipped).

    Raises ValueError on malformed input or count mismatch.
    """
    lib = _load()
    if lib is None:
        values = np.array(
            [t for t in data.decode("ascii", "replace").split() if not t.startswith("#")],
            dtype=np.float64,
        ).astype(np.float32)
        if values.size != expected:
            raise ValueError(f"expected {expected} floats, got {values.size}")
        return values
    out = np.empty(expected, np.float32)
    n = lib.parse_ascii_floats(
        data,
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        expected,
    )
    if n == ctypes.c_size_t(-1).value:
        raise ValueError("malformed numeric token in ascii payload")
    if n != expected:
        raise ValueError(f"expected {expected} floats, got {n}")
    return out


def decode_u16_depth(raw: np.ndarray, scale: float = 0.001, n_threads: int = 4) -> np.ndarray:
    """uint16 depth frame(s) -> float32 meters."""
    lib = _load()
    raw = np.ascontiguousarray(raw, np.uint16)
    if lib is None:
        return raw.astype(np.float32) * scale
    out = np.empty(raw.shape, np.float32)
    lib.decode_u16_depth(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size,
        scale,
        n_threads,
    )
    return out


def transform_points(points: np.ndarray, proj_rowvec: np.ndarray) -> np.ndarray:
    """Host-side (N, 3) @ 4x4 row-vector transform (export fast path)."""
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    m = np.ascontiguousarray(proj_rowvec, np.float32)
    if lib is None:
        return points @ m[:3, :3] + m[3, :3]
    out = np.empty_like(points)
    lib.transform_points(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(points),
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def _lzf_decompress_py(data: bytes, out_len: int) -> bytes:
    """Pure-Python LZF decode (the codec without a compiler)."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 0x20:
            run = ctrl + 1
            if ip + run > n or len(out) + run > out_len:
                raise ValueError("malformed LZF stream")
            out += data[ip : ip + run]
            ip += run
        else:
            length = ctrl >> 5
            if length == 7:
                if ip >= n:
                    raise ValueError("malformed LZF stream")
                length += data[ip]
                ip += 1
            length += 2
            if ip >= n:
                raise ValueError("malformed LZF stream")
            dist = ((ctrl & 0x1F) << 8 | data[ip]) + 1
            ip += 1
            pos = len(out) - dist
            if pos < 0 or len(out) + length > out_len:
                raise ValueError("malformed LZF stream")
            for _ in range(length):  # overlap-safe byte copy
                out.append(out[pos])
                pos += 1
    return bytes(out)


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """Decompress an LZF stream to exactly ``out_len`` bytes.

    Raises ValueError on malformed input or a length mismatch (the PCL
    binary_compressed header states the uncompressed size up front).
    """
    lib = _load()
    if lib is None:
        out = _lzf_decompress_py(data, out_len)
    else:
        buf = (ctypes.c_ubyte * out_len)()
        n = lib.lzf_decompress(data, len(data), buf, out_len)
        if n == 0 and out_len > 0:
            raise ValueError("malformed LZF stream")
        out = bytes(buf[:n])
    if len(out) != out_len:
        raise ValueError(
            f"LZF stream decompressed to {len(out)} bytes, expected {out_len}"
        )
    return out


def _lzf_compress_py(data: bytes) -> bytes:
    """Pure-Python greedy LZF encode (mirrors the native codec)."""
    n = len(data)
    out = bytearray()
    htab: dict = {}
    ip = 0
    lit_start = 0

    def flush(end: int) -> None:
        i = lit_start
        while i < end:
            run = min(end - i, 32)
            out.append(run - 1)
            out.extend(data[i : i + run])
            i += run

    while ip + 2 < n:
        key = data[ip : ip + 3]
        ref = htab.get(key, -1)
        htab[key] = ip
        if ref >= 0 and ip - ref <= 0x2000:
            maxlen = min(n - ip, 264)
            length = 3
            while length < maxlen and data[ref + length] == data[ip + length]:
                length += 1
            flush(ip)
            dist = ip - ref - 1
            lcode = length - 2
            if lcode < 7:
                out.append((lcode << 5) | (dist >> 8))
                out.append(dist & 0xFF)
            else:
                out.append((7 << 5) | (dist >> 8))
                out.append(lcode - 7)
                out.append(dist & 0xFF)
            ip += length
            lit_start = ip
        else:
            ip += 1
    flush(n)
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """LZF-compress ``data`` (the codec PCL uses for binary_compressed
    .pcd payloads)."""
    lib = _load()
    if lib is None:
        return _lzf_compress_py(data)
    cap = len(data) + len(data) // 32 + 64
    buf = (ctypes.c_ubyte * cap)()
    m = lib.lzf_compress(data, len(data), buf, cap)
    if m == 0 and len(data) > 0:
        return _lzf_compress_py(data)  # not reached: cap covers the worst case
    return bytes(buf[:m])

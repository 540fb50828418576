"""Build, load and call the CUDA kernels of ``csrc/``.

All kernels compile with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ONE shared library with a plain C interface, loaded with ctypes (no
PyTorch headers, so a build takes seconds). Each source compiles in its
own ``nvcc`` process, all started together, then one link. The library is
built at first use into ``build/housescan_kernels/`` at the repository
root (git-ignored), named by a hash of the sources and flags, so a changed
source rebuilds and concurrent processes never load a half-written file.

``--fmad=false`` keeps every float32 multiply and add separately rounded,
as on the CPU: the kernels then reproduce their plain PyTorch versions'
arithmetic operation for operation, and the remaining differences come
from summation order alone.

The library also holds one host-only routine, ``hs_convex_hull_2d``
(``csrc/convex_hull.cu``): the scan's plane hulls, a sequential chain over
numpy's float64 points, which the host compiler builds from the same
source (``ops/convex_hull.py``).

``launch_counts`` counts, per kernel, the wrapper calls that launched it;
``plain_counts`` the calls that ran the plain version instead. The host
routine is counted likewise, under ``convex_hull``: calls of the compiled
chain and of the Python chain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "housescan_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("bilateral", "icp_level", "tsdf_stream", "tsdf_free", "raycast_tiles", "solve6",
           "planes_extract", "tsdf_dense", "chunk_select", "marching_tets", "convex_hull",
           "pyramid")
# The kernels each path launches: the kernel path of kinfu_step
# (use_pallas=True), its XLA path (use_pallas=False), and the dense path
# (ops.tsdf_integrate_pallas then ops.raycast_planes.raycast_pallas). A
# scan that writes its mesh adds K10 (marching_tets) to its path's.
KERNEL_PATH = ("bilateral", "pyramid", "icp_level", "tsdf_stream", "tsdf_free",
               "raycast_tiles", "chunk_select")
XLA_PATH = ("bilateral", "pyramid", "solve6")
DENSE_PATH = ("tsdf_dense", "planes_extract", "raycast_tiles")

# Volume layouts of the kernels' storage template (csrc/common.cuh).
LAYOUT_PACKED = 0
LAYOUT_F32 = 1
LAYOUT_BF16 = 2

# The kernels' launch counts and their plain versions' calls; a reload of
# this module in place keeps both dicts (as utils.metrics keeps
# GLOBAL_METRICS), so a caller that imported them still reads the counts.
launch_counts = globals().get("launch_counts") or {}
plain_counts = globals().get("plain_counts") or {}
for _k in KERNELS:
    launch_counts.setdefault(_k, 0)
    plain_counts.setdefault(_k, 0)
# Filled by load(): build seconds (0 when the library was already built)
# and the ptxas register/spill report.
build_info = {"seconds": 0.0, "ptxas": "", "path": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_SIGNATURES = {
    # depth, out, h, w, radius, sigma_space, sigma_depth, stream
    "hs_bilateral": [_P, _P, _I, _I, _I, _D, _D, _P],
    # host arrays of depth and map pointers, levels, h, w, fx, fy, cx, cy,
    # sigma_depth, max_depth_jump, stream
    "hs_pyramid": [_P, _P, _I, _I, _I, _D, _D, _D, _D, _D, _D, _P],
    # packed, hp, wp, pixels a block, of them in shared memory, host
    # params[32], prev pose, dist gate, tight gate (device scalars or
    # null), pose0, state + partials, n_iters, stream
    "hs_icp_level": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    # out: SM count, shared memory a block may opt into
    "hs_device_limits": [_P],
    # vol, layout, planes, desc, count, grid, nx, ny, nz, mip0, h0, w0,
    # mip1, h1, w1, mip2, h2, w2, l3, h3, w3, params, sat_w, stream
    "hs_tsdf_stream": [
        _P, _I, _P, _P, _P, _I, _I, _I, _I,
        _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
        _P, _F, _P,
    ],
    # vol, layout, planes, bitmap, count, bi, bj, bk, grid, nx, ny, nz,
    # params, sat_w, stream
    "hs_tsdf_free": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _P],
    # vol, layout, planes, nx, ny, nz, params, next_chunk, grid, stream
    "hs_planes_extract": [_P, _I, _P, _I, _I, _I, _P, _P, _I, _P],
    # vol, nx, ny, nz, mip0, h0, w0, mip1, h1, w1, mip2, h2, w2, l3, h3, w3,
    # l3min, l3max, l3valid, params, cls, planes, next_col, grid, stream
    "hs_tsdf_dense": [
        _P, _I, _I, _I,
        _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I,
        _P, _P, _P, _P, _P, _P, _P, _I, _P,
    ],
    # cand, n_tiles, max_ct, params, out, h, w_pad, stream
    "hs_raycast_tiles": [_P, _I, _I, _P, _P, _I, _I, _P],
    # a, b, pose, out, damping, max_step, stream
    "hs_solve6": [_P, _P, _P, _P, _F, _F, _P],
    # depth, h, w, planes, params, nbx, nby, nzc, split, v_hi 0-2, u_hi 0-2,
    # scratch, desc, counts, free list, stream
    "hs_chunk_select": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    # h, w, chunks, superblocks, out: scratch bytes
    "hs_chunk_select_scratch": [_I, _I, _I, _I, _P],
    # nx, ny, nz, slab, out: scratch bytes (int64)
    "hs_marching_tets_scratch": [_I, _I, _I, _I, _P],
    # vol, layout, nx, ny, nz, slab, min weight, scratch, total (int64), stream
    "hs_marching_tets_count": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    # vol, layout, nx, ny, nz, slab, params, scratch, cap, out, stream
    "hs_marching_tets_emit": [_P, _I, _I, _I, _I, _I, _P, _P, _L, _P, _P],
    # host-only: points (n, 2) float64, n, out indices, stack; returns the
    # number of indices written
    "hs_convex_hull_2d": [_P, _L, _P, _P],
}
# Return types other than the status int of a launcher.
_RESTYPES = {"hs_convex_hull_2d": _L}
# Each kernel's occupancy query (arg, out): the device kernels it reports,
# in order, at the launch configuration of its wrapper.
OCCUPANCY = {
    "bilateral": ("hs_bilateral_occupancy", ("bilateral_kernel",)),
    "pyramid": ("hs_pyramid_occupancy", ("pyramid_level_kernel",)),
    "icp_level": ("hs_icp_occupancy", ("icp_level_kernel",)),
    "tsdf_stream": ("hs_tsdf_stream_occupancy", ("packed", "float32", "bfloat16")),
    "tsdf_free": ("hs_tsdf_free_occupancy", ("packed", "float32", "bfloat16")),
    "raycast_tiles": ("hs_raycast_tiles_occupancy", ("raycast_tiles_kernel",)),
    "solve6": ("hs_solve6_occupancy", ("solve6_kernel",)),
    "planes_extract": ("hs_planes_extract_occupancy", ("packed", "float32", "bfloat16")),
    "tsdf_dense": ("hs_tsdf_dense_occupancy", ("tsdf_dense_kernel",)),
    "chunk_select": ("hs_chunk_select_occupancy", ("hiz", "classify", "compact")),
    "marching_tets": ("hs_marching_tets_occupancy",
                      ("classify packed", "classify float32", "classify bfloat16", "scan",
                       "emit packed", "emit float32", "emit bfloat16")),
}
for _fn, _ in OCCUPANCY.values():
    _SIGNATURES[_fn] = [_I, _P]

_lib = None


def reset_counts() -> None:
    for k in KERNELS:
        launch_counts[k] = 0
        plain_counts[k] = 0


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def load():
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    so = BUILD_DIR / f"libhousescan_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.time()
        objs = [so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o") for src in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        for obj in objs:
            obj.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        build_info["seconds"] = time.time() - t0
        build_info["ptxas"] = "".join(logs)
        os.replace(tmp, so)
    build_info["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def occupancy(name: str, arg: int = 0) -> dict:
    """{device kernel: resident blocks an SM} of kernel ``name`` (``arg``:
    K3's pixels a block held in shared memory, K6's candidates a tile,
    else unused), from the
    occupancy calculator."""
    fn, labels = OCCUPANCY[name]
    out = (ctypes.c_int * len(labels))()
    check(getattr(load(), fn)(arg, out), fn)
    return dict(zip(labels, out))


_limits = {}


def device_limits() -> tuple:
    """(SM count, shared memory bytes a block may opt into) of the current
    CUDA device, queried once."""
    dev = torch.cuda.current_device()
    if dev not in _limits:
        out = (ctypes.c_int * 2)()
        check(load().hs_device_limits(out), "hs_device_limits")
        _limits[dev] = (out[0], out[1])
    return _limits[dev]


def launch(fn: str, device: torch.device, *args) -> None:
    """Call the library's launcher ``fn`` with ``args`` and the current
    stream of ``device``, the device of the kernel's tensors, with that
    device made current: the library launches on the current device, so
    a tensor on another card than the current one still runs on its own
    card and stream. Raises on a CUDA error."""
    with torch.cuda.device(device):
        check(getattr(load(), fn)(*args, torch.cuda.current_stream(device).cuda_stream), fn)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors, dtype=torch.float32) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``
    on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all inputs must be CUDA tensors on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def volume_layout(name: str, data: torch.Tensor):
    """(layout code, (nx, ny, nz)) of a volume's ``data``: the packed
    (X, Y, Z) int32 grid or the (2, X, Y, Z) float32 or bfloat16 array;
    raises on any other."""
    if data.dtype == torch.int32 and data.dim() == 3:
        return LAYOUT_PACKED, tuple(data.shape)
    planar = {torch.float32: LAYOUT_F32, torch.bfloat16: LAYOUT_BF16}
    if data.dtype in planar and data.dim() == 4 and data.shape[0] == 2:
        return planar[data.dtype], tuple(data.shape[1:])
    raise ValueError(f"{name}: a packed int32 (X, Y, Z) or float32 / bfloat16 (2, X, Y, Z) "
                     f"volume is required, got {data.dtype} {tuple(data.shape)}")


def host_tensor(values, dtype, device) -> torch.Tensor:
    """A small tensor of host values on ``device``. To a CUDA device it is
    copied from pinned memory without blocking, so building it does not
    wait for the work already queued on the stream."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def f32_vector(parts, device) -> torch.Tensor:
    """One float32 vector on ``device`` from Python floats and float32
    tensors (tensors stay on the device: no host synchronisation)."""
    out, run = [], []
    for p in parts:
        if isinstance(p, torch.Tensor):
            if run:
                out.append(host_tensor(run, torch.float32, device))
                run = []
            out.append(p.reshape(-1).to(device=device, dtype=torch.float32))
        else:
            run.append(float(p))
    if run:
        out.append(host_tensor(run, torch.float32, device))
    return torch.cat(out)

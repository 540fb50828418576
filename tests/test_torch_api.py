"""The port's public surface against the JAX package's.

  * Every reference module has a counterpart in the port (one under
    another name, RENAMED), except the Pallas files, whose kernels are
    CUDA sources (PALLAS_FILES).
  * Every name a reference package's ``__init__`` exports imports from
    the port's, and every public function and class of a reference module
    exists in its counterpart (one exemption, below).
  * The signature rule: for every public function both packages define,
    the port's positional parameters are the reference's, name for name,
    up to the reference's first JAX-only parameter (``interpret``); every
    parameter after that point, and every parameter only the port has
    (``device``, ``global_blocks``, ...), is keyword-only. The reference's
    random ``key`` is the port's ``generator`` in the same place.
    ``kinfu.tsdf.integrate_core`` is the one exemption: the port's takes
    the volume's grids split out (``t_old``, ``w_old``, ``x0``), which its
    slab and layout callers pass.
  * The functions the rule reordered or extended bind like the
    reference's: ``icp_track`` with ``init_pose``, ``windows`` and
    ``dampings`` passed by position against the reference's XLA path
    (pose within 1e-5 m, the XLA path's per-iteration tolerance), and
    ``marching_cubes(max_triangles=)`` (a twin of
    tests/test_marching_cubes.py's cap test).
"""

import importlib
import importlib.util
import inspect
import os
import pkgutil

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np
import torch

import housescan_tpu
import housescan_tpu_torch

# The Pallas kernel files (each reaches pl.pallas_call) and where the port
# keeps their kernels: the CUDA source and the module with the wrapper and
# its plain version.
PALLAS_FILES = {
    "housescan_tpu.ops.preprocess_pallas": ("csrc/bilateral.cu", "ops.preprocess_cuda"),
    "housescan_tpu.ops.solve6_pallas": ("csrc/solve6.cu", "ops.solve6"),
    "housescan_tpu.ops.icp_pallas": ("csrc/icp.cu", "ops.icp_cuda"),
    "housescan_tpu.ops.tsdf_pallas": ("csrc/tsdf_dense.cu", "ops.tsdf_cuda"),
    "housescan_tpu.ops.planes_pallas": ("csrc/planes_extract.cu", "ops.planes_cuda"),
}
# A module the port names otherwise: ops/raycast_pallas.py calls no Pallas
# kernel itself (K6 is ops/raycast_tiles.py's); its functions are here.
RENAMED = {"housescan_tpu.ops.raycast_pallas": "housescan_tpu_torch.ops.raycast_planes"}
# Reference names with no counterpart, and why.
NOT_PORTED = {
    # JAX's persistent compile cache; the CUDA kernels are cached by
    # ops/cuda_lib.py, keyed by their sources' hash.
    "housescan_tpu.config.enable_compilation_cache",
}
SIGNATURE_EXEMPT = {
    # Takes the volume's grids split out (t_old, w_old, x0).
    "housescan_tpu.kinfu.tsdf.integrate_core",
}

REF_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(housescan_tpu.__path__, "housescan_tpu.")
    if not m.name.endswith("__main__")
)


def _port_name(name: str) -> str:
    return RENAMED.get(name) or "housescan_tpu_torch" + name[len("housescan_tpu"):]


def _public(module):
    """(name, object) of the functions and classes ``module`` defines
    (a jitted function by the Python function it wraps)."""
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        if not inspect.isfunction(obj) and inspect.isfunction(getattr(obj, "__wrapped__", None)):
            obj = obj.__wrapped__
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and obj.__module__ == module.__name__:
            yield name, obj


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_every_reference_module_has_a_counterpart():
    root = housescan_tpu_torch.__path__[0]
    missing = []
    for name in REF_MODULES:
        if name in PALLAS_FILES:
            source, module = PALLAS_FILES[name]
            assert (importlib.util.find_spec(f"housescan_tpu_torch.{module}") is not None
                    and os.path.exists(f"{root}/{source}")), name
            continue
        if importlib.util.find_spec(_port_name(name)) is None:
            missing.append(name)
    assert not missing, f"reference modules with no counterpart: {missing}"


@pytest.mark.parametrize("package", [m for m in REF_MODULES
                                     if hasattr(importlib.import_module(m), "__path__")]
                         + ["housescan_tpu"])
def test_package_exports_import_from_port(package):
    ref = importlib.import_module(package)
    # The top level has no __all__: it imports geometry, solvers and utils.
    names = ref.__all__ if package != "housescan_tpu" else ["__version__", "geometry",
                                                            "solvers", "utils"]
    port = importlib.import_module(_port_name(package))
    assert [n for n in names if not hasattr(port, n)] == []


def test_named_exports_import():
    from housescan_tpu_torch.capture import DepthStream, ReplaySource, record_stream  # noqa: F401
    from housescan_tpu_torch.io import load_pcd, save_xf  # noqa: F401
    from housescan_tpu_torch.kinfu import icp_track, kinfu_step, tsdf_new  # noqa: F401
    from housescan_tpu_torch.kinfu.camera import in_bounds
    from housescan_tpu_torch.kinfu.pipeline import inverse_rigid
    from housescan_tpu_torch.capture.replay import take_depth_snapshot  # noqa: F401

    intr = housescan_tpu_torch.kinfu.Intrinsics(4, 3, 1.0, 1.0, 1.5, 1.0)
    ok = in_bounds(intr, torch.tensor([-0.1, 0.0, 3.0, 3.1]), torch.tensor([0.0, 2.0, 2.0, 1.0]))
    assert ok.tolist() == [False, True, True, False]
    m = torch.eye(4)
    m[3, :3] = torch.tensor([1.0, 2.0, 3.0])
    assert torch.allclose(inverse_rigid(m) @ m, torch.eye(4))


@pytest.mark.parametrize("module", [m for m in REF_MODULES if m not in PALLAS_FILES])
def test_public_names_and_signature_rule(module):
    ref = importlib.import_module(module)
    port = importlib.import_module(_port_name(module))
    missing, broken = [], []
    for name, obj in _public(ref):
        qual = f"{module}.{name}"
        if qual in NOT_PORTED:
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        if not inspect.isfunction(obj) or qual in SIGNATURE_EXEMPT:
            continue
        theirs = _positional(obj)
        if "interpret" in theirs:
            theirs = theirs[:theirs.index("interpret")]
        theirs = ["generator" if p == "key" else p for p in theirs]
        fn = getattr(port, name)
        mine = _positional(getattr(fn, "__wrapped__", fn))
        # "key" stays "key" where it is a sort key, not a random key
        if mine != theirs and mine != [p if p != "generator" else "key" for p in theirs]:
            broken.append(f"{name}: reference {theirs}, port {mine}")
    assert missing == [], f"{module} lacks {missing}"
    assert broken == [], "\n".join(broken)


def test_icp_track_binds_like_reference():
    """``init_pose``, ``windows`` and ``dampings`` by position, on the XLA
    path of both packages, from a pose 2 cm off the model's."""
    from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics
    from housescan_tpu.kinfu.icp import icp_track as j_icp_track
    from housescan_tpu_torch.kinfu import maps as mp
    from housescan_tpu_torch.kinfu.camera import Intrinsics
    from housescan_tpu_torch.kinfu.icp import DAMPINGS, WINDOWS, icp_track
    from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step
    from housescan_tpu_torch.kinfu.preprocess import build_pyramid
    from housescan_tpu_torch.kinfu.synthetic import furnished_room, orbit_poses, render_depth_stream

    torch.set_num_threads(1)
    intr = Intrinsics(160, 120, 131.25, 131.25, 79.5, 59.5)
    half, boxes = furnished_room()
    poses = orbit_poses(2, radius=0.25, yaw_range=0.03, pitch=0.25)
    frames = render_depth_stream(intr, poses, half, boxes=boxes, device="cpu")
    state = kinfu_init(intr, resolution=64, size_m=3.0, trunc=0.1, init_pose=poses[0],
                       device="cpu")
    state = kinfu_step(state, frames[0], intr, use_pallas=False)
    live = list(build_pyramid(frames[1], intr, levels=3).maps)
    model = mp.build_map_pyramid(state.model_maps, 3)
    init = state.pose.clone()
    init[3, 0] += 0.02
    windows, dampings = (0, 1, 2), (1e-3, 3e-3, 1e-2)
    args = ((6, 3, 2), 0.10, 0.5236, init, windows, dampings, False)
    got = icp_track(live, model, state.pose, intr, *args)

    def j(t):
        return jnp.asarray(t.numpy())

    want = j_icp_track([j(m) for m in live], [j(m) for m in model], j(state.pose),
                       JIntrinsics(*intr), *args[:3], j(init), *args[4:])
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    assert int(got.n_corr) == int(want.n_corr)
    # the defaults are the reference's constants, and init_pose defaults to prev_pose
    assert (WINDOWS, DAMPINGS) == ((0, 2, 4), (3e-4, 3e-3, 1e-2))
    a = icp_track(live, model, state.pose, intr, (6, 3, 2), 0.10, 0.5236, None, WINDOWS,
                  DAMPINGS, False)
    b = icp_track(live, model, state.pose, intr, (6, 3, 2), 0.10, 0.5236, use_pallas=False)
    assert torch.equal(a.pose, b.pose)


def test_marching_cubes_cap_truncates_with_message(capsys):
    from housescan_tpu_torch.kinfu.marching_cubes import marching_cubes
    from housescan_tpu_torch.kinfu.tsdf import tsdf_new

    res, r = 48, 0.9
    vol = tsdf_new(res, 3.0, 0.15, device="cpu")
    idx = (np.arange(res) + 0.5) * (3.0 / res) - 1.5
    gx, gy, gz = np.meshgrid(idx, idx, idx, indexing="ij")
    gt = np.clip((r - np.sqrt(gx * gx + gy * gy + gz * gz)) / 0.15, -1, 1).astype(np.float32)
    vol = vol.replace_grids(tsdf=torch.from_numpy(gt), weight=torch.ones(res, res, res))
    full = marching_cubes(vol)
    n_full = len(full.faces)
    assert n_full > 600
    assert capsys.readouterr().err == ""
    cap = 512
    mesh = marching_cubes(vol, max_triangles=cap)
    err = capsys.readouterr().err
    assert "exceed capacity 512" in err and "max_triangles" in err
    assert len(mesh.faces) == cap
    np.testing.assert_array_equal(mesh.vertices, full.vertices[: 3 * cap])
    assert len(marching_cubes(vol, max_triangles=n_full).faces) == n_full

#!/usr/bin/env python3
"""The port's XLA path against the reference's on the CPU at bench width.

Not a test (pytest does not collect it): it runs the bench orbit of
``chip_smoke.py`` (the furnished room, ``orbit_poses(21, radius=0.25,
yaw_range=0.4, pitch=0.25)``, 640x480 depth, fx = fy = 525, a float32
volume over 3 m with trunc 0.03) through ``kinfu_step(use_pallas=False)``
in both packages on the CPU and prints each one's final position, its
error against the true pose, the distance between the two final
positions, tracked frames and seconds a frame.

    JAX_PLATFORMS=cpu python tests/torch_xla_width_check.py --res 480

``--res 480`` is the xla-480 configuration (2 x 480^3 x 4 B = 0.885 GB
of volume; the reference's XLA program holds several such grids at
once). A smaller ``--res`` that does not tile into 128 voxels (e.g. 240)
keeps the same path at a fraction of the memory.
"""

import argparse
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from housescan_tpu.kinfu.camera import Intrinsics as JIntrinsics  # noqa: E402
from housescan_tpu.kinfu.pipeline import kinfu_init as j_init  # noqa: E402
from housescan_tpu.kinfu.pipeline import kinfu_step as j_step  # noqa: E402
from housescan_tpu_torch.kinfu.camera import Intrinsics  # noqa: E402
from housescan_tpu_torch.kinfu.pipeline import kinfu_init, kinfu_step  # noqa: E402
from housescan_tpu_torch.kinfu.synthetic import (  # noqa: E402
    furnished_room,
    orbit_poses,
    render_depth_stream,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=480)
    ap.add_argument("--frames", type=int, default=21)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    intr = Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5)
    poses = orbit_poses(args.frames, radius=0.25, yaw_range=0.02 * (args.frames - 1), pitch=0.25)
    half, boxes = furnished_room()
    frames = render_depth_stream(intr, poses, half, boxes, device="cpu")
    truth = poses[-1][3, :3]

    out = {}
    jintr = JIntrinsics(*intr)
    st = j_init(jintr, resolution=args.res, size_m=3.0, trunc=0.03, init_pose=jnp.asarray(poses[0]))
    tracked, t0 = 0, time.perf_counter()
    for i in range(args.frames):
        st = j_step(st, jnp.asarray(frames[i].numpy()), jintr, use_pallas=False)
        tracked += int(i > 0 and bool(st.last_tracked))
    out["reference"] = (np.array(st.pose)[3, :3], tracked, time.perf_counter() - t0)
    del st

    ts = kinfu_init(intr, resolution=args.res, size_m=3.0, trunc=0.03, init_pose=poses[0],
                    dtype=torch.float32, device="cpu")
    tracked, t0 = 0, time.perf_counter()
    for i in range(args.frames):
        ts = kinfu_step(ts, frames[i], intr, use_pallas=False)
        tracked += int(i > 0 and bool(ts.last_tracked))
    out["port"] = (ts.pose[3, :3].numpy(), tracked, time.perf_counter() - t0)

    for name, (pos, n_tracked, secs) in out.items():
        print(f"{name}: {args.res}^3 float32, {args.frames} frames: final position {pos.tolist()}, "
              f"pose error {np.linalg.norm(pos - truth) * 1000:.4f} mm, tracked "
              f"{n_tracked}/{args.frames - 1}, {secs / args.frames:.3f} s/frame on the CPU")
    gap = np.linalg.norm(out["port"][0] - out["reference"][0]) * 1000
    print(f"port - reference final position: {gap:.4f} mm (the reference's s/frame includes its "
          f"compile; the port ran {torch.get_num_threads()} torch threads; peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB)")


if __name__ == "__main__":
    main()

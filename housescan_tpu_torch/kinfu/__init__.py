"""KinFu tracking and fusion (camera, volume, preprocess, maps, ICP, the
step) and the scan stage (surface points, RANSAC, marching tetrahedra,
checkpoints, the room directory)."""

"""KinFu tracking and fusion: camera, volume, preprocess, maps, ICP, the step."""

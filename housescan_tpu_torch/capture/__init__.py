"""Depth-stream capture: recorded-stream replay."""

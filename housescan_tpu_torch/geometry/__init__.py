"""Geometry: rigid transforms (row-vector convention), planes and the
weighted plane fit."""

"""Rigid-transform helpers (row-vector convention)."""

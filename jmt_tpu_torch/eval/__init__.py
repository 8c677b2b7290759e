"""Stitched, smoothed evaluation of per-window predictions."""

"""Utilities: colormaps and rendering, PNG output, overlays, video,
metrics and profiling."""

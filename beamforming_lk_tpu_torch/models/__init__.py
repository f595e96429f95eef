"""Tracker swarm, MISO listener, heatmap grid and target lists; the
adaptive heatmaps MVDR (Capon, ``mvdr``) and wideband MUSIC (``music``);
calibration, fusion and the Kalman filter."""

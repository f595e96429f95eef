"""Tracker swarm, MISO listener, heatmap grid and target lists."""

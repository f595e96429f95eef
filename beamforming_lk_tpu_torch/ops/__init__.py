"""Tensor ops: geometry, steering, DAS, the FFT heatmap and the swarm-chain kernel."""

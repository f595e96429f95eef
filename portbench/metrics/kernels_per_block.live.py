"""Device kernels (copies and fills left out) in the traced window, a
block: the launch path of the ring, the heatmap and the tracker ops."""

from portbench.readers import kernels_per_block as read  # noqa: F401

"""Host ms a block in the port's `awpu.heatmap` span, in the traced window:
the fft heatmap and its EMA on the blocks that compute one (in a replay,
a chunk's batched maps), `app/awpu.py`."""

from portbench.spans import heatmap_host_ms as read  # noqa: F401

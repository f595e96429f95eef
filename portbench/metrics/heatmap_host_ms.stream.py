"""Host ms a block in the port's `awpu.heatmap` span, in the traced window:
the dense heatmap (K4) and its EMA, every block of the default profile,
`app/awpu.py`."""

from portbench.spans import heatmap_host_ms as read  # noqa: F401

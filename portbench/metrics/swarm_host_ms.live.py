"""Host ms a block in the port's `awpu.swarm` and `awpu.miso` spans, in the
traced window: the swarm kernel's operand prep, draws and launch (K1 a
live block, K2 a replayed chunk), `models/tracker.py`."""

from portbench.spans import swarm_host_ms as read  # noqa: F401

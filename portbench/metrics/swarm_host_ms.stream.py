"""Host ms a block in the port's `awpu.swarm` and `awpu.miso` spans, in the
traced window: the XLA-chain tracker (K0 and the ops between its
iterations) and the MISO step of the default profile, `models/tracker.py`,
`models/miso.py`."""

from portbench.spans import swarm_host_ms as read  # noqa: F401

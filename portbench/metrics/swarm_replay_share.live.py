"""Per cent of the traced live blocks whose fused swarm step (prep, draws,
K1 and its unpacking) ran as one CUDA graph replay: the port's
`awpu.swarm.replay` spans (`models/tracker.py::FusedSwarmStep`,
`utils/graphs.py`) that open in the traced window, over the traced blocks.
None where no such span opened (a program that runs the step eagerly)."""

from portbench.spans import SWARM

REPLAY = SWARM + ".replay"


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_blocks", 0)
    if tr is None or not n:
        return None
    w0, w1 = tr.window
    opened = sum(1 for name, s, _ in tr.host if name == REPLAY and w0 <= s < w1)
    return opened / n * 100.0 if opened else None

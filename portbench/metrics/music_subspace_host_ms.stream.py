"""Host ms a block in the port's `awpu.estimator.subspace` span, in the
traced window: MUSIC's orthogonal-iteration rounds (a product and a QR
each) and Rayleigh quotients, `models/music.py::MusicStep.subspaces`.
None where the program opens no such span."""

from portbench.spans import host_ms_per_block


def read(ctx):
    return host_ms_per_block(ctx, "awpu.estimator.subspace")

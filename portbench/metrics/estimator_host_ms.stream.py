"""Host ms a block in the port's `awpu.estimator` span, in the traced
window: the adaptive estimator's whole step (MUSIC's covariance EMA, QR
rounds and spectrum, or MVDR's), `app/awpu.py`, `models/music.py`,
`models/mvdr.py`.  None where the program opens no such span."""

from portbench.spans import host_ms_per_block


def read(ctx):
    return host_ms_per_block(ctx, "awpu.estimator")

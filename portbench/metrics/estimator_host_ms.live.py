"""Host ms a block in the port's `awpu.estimator` span, in the traced
window of a live cell: the adaptive estimator's whole step (MVDR's
covariance EMA, factor and direction stage, `models/mvdr.py`), launched
inside the entry call (`app/awpu.py`).  The live twin of
`estimator_host_ms.stream`.  None where the program opens no such span."""

from portbench.spans import host_ms_per_block


def read(ctx):
    return host_ms_per_block(ctx, "awpu.estimator")

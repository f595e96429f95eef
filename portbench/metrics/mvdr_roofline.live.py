"""Per cent of the MVDR step's least device time a block that the traced
window reaches: the least time over the device's busy time a block outside
the swarm and heatmap kernels, ``(busy - K0, K1, K2, K4 time) / traced
blocks``.

No kernel name of the estimator is matched: cuBLAS's ``trsm`` kernels run
inside cuSOLVER's Cholesky too, and a later change that carries out the
solve another way (an inverse and a product, a hand kernel, a graph)
would leave a reader by name empty.  The denominator reads the same work
whatever carries it out, and with it what else runs outside those
kernels: the intake's copy, the swarm graph's small kernels and the
listener's, ~0.1 ms a block at 256 mics.  So the share reads a little
low, and alike on both sides of any comparison.

The least time (:func:`counts`) is that of a block's step at the
configuration's sizes, F bins (as ``CovarianceStep`` selects them from
the band), C channels, D directions, M frames of N samples: operations
F D (2C)^2 for the triangular solve against every steering vector, F
(2C)^3 / 3 for the Cholesky of the real embedding, 2 F (2C)^2 M for the
covariance, 4 C M N F for the DFT and 2 F D 2C for the norms; bytes the
steering planes ``v_emb`` [F, D, 2C] f32 read once, the solution of the
same size written and read once, the covariance planes [F, C, C] x2 and
the embedding [F, 2C, 2C] read and written once each.  The count is of
a block that refreshes its spectrum, as every block does at
``mvdr_refresh`` 1, the cell's.  Under the published f32 peak the
operations bind (the step runs without TF32).
"""

from portbench import peaks
from portbench.peaks import PEAK_FLOPS
from portbench.readers import K0, K1, K2, K4
from portbench.reference.estimators.music import BAND, FRAME, HOP

F32 = 4


def counts(cfg):
    fs = cfg["array"]["sample_rate"]
    f = sum(1 for k in range(1, FRAME // 2) if BAND[0] <= k * fs / FRAME <= BAND[1])
    c2, d = 2 * cfg["channels"], cfg["mimo"]["rows"] * cfg["mimo"]["columns"]
    m = (cfg["dsp"]["block_size"] - FRAME) // HOP + 1
    flops = (f * d * c2 ** 2 + f * c2 ** 3 / 3.0 + 2.0 * f * c2 ** 2 * m
             + 2.0 * c2 * m * FRAME * f + 2.0 * f * d * c2)
    nbytes = F32 * (3 * f * d * c2 + 3 * f * c2 ** 2)
    return flops, nbytes, PEAK_FLOPS["float32"]


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_blocks", 0)
    if tr is None or not n or not tr.ops:
        return None
    swarm = sum(e - s for _, s, e in tr.kernels(K0, K1, K2, K4))
    per_block = (tr.busy_s() - swarm) / n
    if per_block <= 0:
        return None
    flops, nbytes, peak = counts(ctx["config"])
    return peaks.bound_s(flops, nbytes, peak) / per_block * 100.0

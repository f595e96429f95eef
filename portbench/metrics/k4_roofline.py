"""Per cent of the dense heatmap kernel K4's least time (``das_beam_kernel``,
``csrc/das_beam.cu``) that its traced launches reach.

One launch beamforms one window [C, T+S] over the grid's D directions
with a ``taps``-tap stencil a channel (``chip_smoke.py``'s ``compare_das``
counts): 2 D C taps T operations; bytes read once, the window (f32), the
shifts (int32 [D, C]) and the tap weights (f32 [D, C, taps]), and the
beam written once (f32 [D, T]).  The count does not depend on the data.
Under the published f32 peak outside the tensor cores, the operations
bind at 64 mics.
"""

from portbench.peaks import PEAK_FLOPS
from portbench.readers import K4, roofline

TAPS = 2     # linear interpolation


def counts(cfg):
    d = cfg["mimo"]["rows"] * cfg["mimo"]["columns"]
    c, t, s = cfg["channels"], cfg["dsp"]["block_size"], cfg["dsp"]["shift_range"]
    flops = 2.0 * d * c * TAPS * t
    nbytes = 4 * c * (t + s) + 4 * d * c + 4 * d * c * TAPS + 4 * d * t
    return flops, nbytes, PEAK_FLOPS["float32"]


def read(ctx):
    return roofline(ctx, K4, counts)

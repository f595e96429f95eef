"""Host time a block in the program's own stages: the port's spans
(``beamforming_lk_tpu_torch.utils.profiling.span``), which a traced window
holds as host events (``Trace.host``) on the profiler's clock.  A program
that opens no such span reads nothing (None), and its metric is left out
of the line."""

from __future__ import annotations

#: Span names in the port (``app/awpu.py``).
INTAKE, HEATMAP, SWARM, MISO = ("awpu.intake", "awpu.heatmap", "awpu.swarm",
                                "awpu.miso")


def host_ms_per_block(ctx, *names):
    """Host ms a block inside spans named ``names`` in the traced window:
    their intervals clipped to the window, a stretch covered by two of
    them (one nested in the other) counted once, over the traced blocks.
    None where no such span opened in the window."""
    tr, n = ctx.get("trace"), ctx.get("traced_blocks", 0)
    if tr is None or not n:
        return None
    w0, w1 = tr.window
    spans = sorted((max(s, w0), min(e, w1)) for name, s, e in tr.host
                   if name in names)
    total, reached, found = 0.0, w0, False
    for s, e in spans:
        if e <= s:
            continue
        found = True
        total += max(0.0, e - max(s, reached))
        reached = max(reached, e)
    return total / n * 1e3 if found else None


def intake_ms(ctx):
    return host_ms_per_block(ctx, INTAKE)


def heatmap_host_ms(ctx):
    return host_ms_per_block(ctx, HEATMAP)


def swarm_host_ms(ctx):
    return host_ms_per_block(ctx, SWARM, MISO)

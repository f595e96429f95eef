"""Median [ms] of every block's due-to-host time over the window."""

from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 50.0)

"""99th percentile [ms] of every block's time from its due time (its last
sample's arrival) to its targets and beam on the host, over the window."""

from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 99.0)

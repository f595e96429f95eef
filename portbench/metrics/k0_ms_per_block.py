"""Device ms a block in the monopulse-chain kernel K0
(`monopulse_chain_kernel`, `csrc/swarm_chain.cu`: the XLA-chain tracker's
iterations and the MISO step), in the traced window."""

from portbench.readers import K0, kernel_ms_per_block


def read(ctx):
    return kernel_ms_per_block(ctx, K0)

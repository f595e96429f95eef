"""Device ms a block in the per-block swarm kernel K1
(`swarm_chain_kernel`, `csrc/swarm_chain.cu`), in the traced window."""

from portbench.readers import K1, kernel_ms_per_block


def read(ctx):
    return kernel_ms_per_block(ctx, K1)

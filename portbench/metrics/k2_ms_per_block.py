"""Device ms a block in the 12-block swarm chunk kernel K2
(`swarm_chunk_kernel`, `csrc/swarm_chain.cu`), in the traced window."""

from portbench.readers import K2, kernel_ms_per_block


def read(ctx):
    return kernel_ms_per_block(ctx, K2)

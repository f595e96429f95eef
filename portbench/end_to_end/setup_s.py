"""Seconds from process start to the first timed block: imports, the
CUDA context, the kernels (built on a checkout's first run, loaded
after), the pipeline, the traffic and the warm-up."""


def read(ctx):
    return ctx["window"]["setup_s"]

"""Host time [ms] inside the entry call (`process_block` or
`process_blocks`, before the benchmark's sync), a block, over the untraced
window: the control unit and AWPU step's launch path (`app/awpu.py`)."""

from portbench.readers import host_enqueue_ms as read  # noqa: F401

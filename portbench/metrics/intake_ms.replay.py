"""Host ms a block in the port's `awpu.intake` span, in the traced window:
`AwpuPipeline._blocks` (`app/awpu.py`), the host block's copy to the card,
where the entry call syncs."""

from portbench.spans import intake_ms as read  # noqa: F401

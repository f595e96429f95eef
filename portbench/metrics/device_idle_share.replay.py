"""Per cent of the time blocks were in flight (entry call to outputs on
the host) in the traced window in which no device operation ran."""

from portbench.readers import idle_share as read  # noqa: F401

"""Share of the traced window in which no operation ran on the traced
rank's device (the last band's), in % (`perfbench.trace.idle_share`)."""

from perfbench.trace import idle_share as read  # noqa: F401

"""Share of the traced window, in %, in which no kernel, copy or set ran on
the card (the device layer)."""

from harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)

"""Share of the traced slice with nothing running on the card (percent)."""
from harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)

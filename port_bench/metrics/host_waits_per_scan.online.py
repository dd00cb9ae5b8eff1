"""The host's counted waits for the card (Mapper.waits) per scan of the window."""
from harness import readers


def read(ctx):
    return readers.waits_per_scan(ctx)

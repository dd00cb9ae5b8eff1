"""Device ms of the merge per scan (PhaseTimer phase merge, CUDA events)."""
from harness import readers


def read(ctx):
    return readers.phase_ms_per_scan(ctx, "merge")

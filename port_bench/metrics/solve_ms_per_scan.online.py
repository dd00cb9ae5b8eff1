"""Device ms of the ICP solve per scan (PhaseTimer phase solve, CUDA events)."""
from harness import readers


def read(ctx):
    return readers.phase_ms_per_scan(ctx, "solve")

"""The nearest-neighbour kernels' share of their roofline (percent): the
least time of their calls in the traced slice (``readers.nn_call_bytes``
at the card's peak bandwidth) over their device time."""
from harness import readers

KERNELS = ("sweep_knn", "knn_brute")


def read(ctx):
    return readers.nn_roofline_pct(ctx, KERNELS)

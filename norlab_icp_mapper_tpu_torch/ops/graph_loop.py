"""A WHILE loop as a node of a CUDA graph (``csrc/graph_loop.cu``).

The JAX package runs its ICP iterations as ``lax.while_loop`` inside one
device program.  On the card the loop becomes a conditional WHILE node of
a CUDA graph that torch is capturing: :func:`while_node` opens the node on
the capturing stream, the caller runs the loop's body inside the ``with``
block (it is recorded into the node's body graph), and leaving the block
appends the kernel that sets the loop's condition, ``!done && it <
max_iter``, from the state the body left in ``it`` (0-d int32) and
``done`` (0-d bool).  A replay of the graph then runs the body until the
condition is false without a single read on the host.

The body is recorded on a stream of its own that torch sees as current,
and every tensor the body allocates comes from ``pool``, a
``torch.cuda.MemPool`` that the caller keeps as long as the graph lives: the
caching allocator would otherwise hand the body's temporaries to other work
while the graph still reads them.

Only on a CUDA device: there is no plain version, the CPU runs the same
body under a Python ``while`` (see ``icp/engine.py``).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

__all__ = ["while_node", "replay"]


def _lib():
    from ._build import load
    lib = load("graph_loop")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.graph_while_begin.argtypes = [vp, vp, vp, vp, ci,
                                          ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_while_begin.restype = ci
        lib.graph_while_end.argtypes = [vp, ctypes.c_ulonglong, vp, vp, ci]
        lib.graph_while_end.restype = ci
        lib._typed = True
    return lib


@contextlib.contextmanager
def while_node(it: torch.Tensor, done: torch.Tensor, max_iter: int,
               body_stream: torch.cuda.Stream, pool: torch.cuda.MemPool):
    """Record the ``with`` block as the body of a WHILE node of the graph
    being captured on the current stream.  ``it`` / ``done`` must outlive
    the graph; the condition is tested before the first run of the body, as
    ``lax.while_loop`` tests it."""
    if it.dtype != torch.int32 or it.shape != () or not it.is_cuda:
        raise ValueError("while_node: `it` is a 0-d int32 CUDA tensor")
    if done.dtype != torch.bool or done.shape != () or not done.is_cuda:
        raise ValueError("while_node: `done` is a 0-d bool CUDA tensor")
    lib = _lib()
    capture = torch.cuda.current_stream()
    handle = ctypes.c_ulonglong(0)
    err = lib.graph_while_begin(capture.cuda_stream, body_stream.cuda_stream,
                                it.data_ptr(), done.data_ptr(),
                                int(max_iter), ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(
            f"graph_while_begin failed (code {err}; -1: the current stream "
            "is not capturing a graph)")
    try:
        with torch.cuda.stream(body_stream), torch.cuda.use_mem_pool(pool):
            yield
    finally:
        err = lib.graph_while_end(body_stream.cuda_stream, handle.value,
                                  it.data_ptr(), done.data_ptr(),
                                  int(max_iter))
    if err != 0:
        raise RuntimeError(f"graph_while_end failed (code {err})")


def replay(graph: torch.cuda.CUDAGraph) -> None:
    """Launch a graph that holds a WHILE node (its condition kernel and the
    body's kernels) on the current stream; counts the launch."""
    graph.replay()
    replay.launches += 1


replay.launches = 0  # graph launches (the Python loop on the CPU adds none)

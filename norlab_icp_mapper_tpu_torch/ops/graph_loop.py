"""The ICP loop on the card (``csrc/graph_loop.cu``): a WHILE loop as a node
of a CUDA graph, and the commit of one iteration as one kernel.

The JAX package runs its ICP iterations as ``lax.while_loop`` inside one
device program.  On the card the loop becomes a conditional WHILE node of
a CUDA graph that torch is capturing: :func:`while_node` opens the node on
the capturing stream (with the loop's first test, ``!done && it <
max_iter``) and yields a :class:`WhileBody`; the caller runs the loop's
body inside the ``with`` block (it is recorded into the node's body graph),
and the body's last :func:`loop_commit`, handed the :class:`WhileBody`,
sets the condition from the state it has just written.  A replay of the
graph then runs the body until the condition is false without a single
read on the host.

The body is recorded on a stream of its own that torch sees as current,
and every tensor the body allocates comes from ``pool``, a
``torch.cuda.MemPool`` that the caller keeps as long as the graph lives: the
caching allocator would otherwise hand the body's temporaries to other work
while the graph still reads them.

:func:`loop_commit` is the end of the JAX body (``icp/engine.py:599-621``)
on the loop state: ``T <- dT T``; the step's translation norm and rotation
angle rolled into the differential checker's window and its means held
against the thresholds once ``it + 1 >= smooth``; the bound checker on the
new ``T``; the identity minimizer's stop; every state tensor written as
``where(active, new, old)`` with ``active = !done && it < max_iter`` (an
iteration after the stop changes no bit); ``it += active``.  On a CUDA
tensor it is one launch of one warp (eager, the same commit was about 35
launches of 0-d to 4x4 tensors); on the CPU it is :func:`loop_commit_plain`,
the same arithmetic in tensor operations: the norms and the window means
spelled out elementwise in index order, every operation rounded on its
own, and the product ``dT @ T``, which the kernel computes with the fused
multiply-adds that ``torch.matmul`` uses on the card for these shapes (a
product spelled out with every operation rounded moved the p2plane map by
0.46 % on the hall sequence).  So kernel and plain version agree bit for
bit on the card, and the solve's T is the one the eager commit gave.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["while_node", "replay", "WhileBody", "no_gc", "loop_commit",
           "loop_commit_plain"]


def _lib():
    from ._build import load
    lib = load("graph_loop")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.graph_while_begin.argtypes = [vp, vp, vp, vp, ci,
                                          ctypes.POINTER(ctypes.c_ulonglong)]
        lib.graph_while_begin.restype = ci
        lib.graph_while_end.argtypes = [vp]
        lib.graph_while_end.restype = ci
        lib.loop_commit_launch.argtypes = (
            [vp] * 5 + [ci] + [vp] * 6
            + [ci, ci, ci, ci, cf, cf, ci, ci, cf, cf, ctypes.c_ulonglong,
               ci, vp])
        lib.loop_commit_launch.restype = ci
        lib._typed = True
    return lib


class WhileBody:
    """The body of a WHILE node being captured: its condition handle, which
    the body's last :func:`loop_commit` sets, and whether one did."""

    def __init__(self, handle: int, max_iter: int):
        self.handle = handle
        self.max_iter = max_iter
        self.condition_set = False


@contextlib.contextmanager
def while_node(it: torch.Tensor, done: torch.Tensor, max_iter: int,
               body_stream: torch.cuda.Stream, pool: torch.cuda.MemPool):
    """Record the ``with`` block as the body of a WHILE node of the graph
    being captured on the current stream; yields the :class:`WhileBody`
    whose condition the block's last :func:`loop_commit` must set (the
    capture raises if none did: the loop would never end).  ``it`` /
    ``done`` must outlive the graph; the condition is tested before the
    first run of the body, as ``lax.while_loop`` tests it."""
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
    body = WhileBody(handle.value, int(max_iter))
    try:
        with torch.cuda.stream(body_stream), torch.cuda.use_mem_pool(pool):
            yield body
    finally:
        err = lib.graph_while_end(body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"graph_while_end failed (code {err})")
    if not body.condition_set:
        raise RuntimeError("while_node: the body never set its condition "
                           "(pass the WhileBody to its last loop_commit)")


@contextlib.contextmanager
def no_gc():
    """Python's cyclic garbage collector kept out of a graph capture: an
    object it would free there (an old solve's graph or memory pool) gives
    device memory back mid-capture, which the caching allocator refuses by
    aborting the process.  The collector is off until the block ends (no
    collection first: a full one costs a capture scan ~90 ms on the host)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def replay(graph: torch.cuda.CUDAGraph) -> None:
    """Launch a graph that holds a WHILE node (its condition kernel and the
    body's kernels) on the current stream; counts the launch."""
    graph.replay()
    replay.launches += 1


replay.launches = 0  # graph launches (the Python loop on the CPU adds none)


# --------------------------------------------------------------------------
# one iteration's commit
# --------------------------------------------------------------------------

def _norm_and_angle(M: torch.Tensor, d: int) -> Tuple[torch.Tensor, ...]:
    """The translation norm and the rotation angle (the JAX package's
    ``_rot_angle``) of a transform ``M [D+1, D+1]``, in the kernel's order
    of operations."""
    acc = M[0, d] * M[0, d]
    for i in range(1, d):
        acc = acc + M[i, d] * M[i, d]
    norm = torch.sqrt(acc)
    if d == 2:
        return norm, torch.abs(torch.atan2(M[1, 0], M[0, 0]))
    tr = (M[0, 0] + M[1, 1]) + M[2, 2]
    return norm, torch.acos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def _check(dT, T, it, done, hist, overlap_new, overlap, rms_new, rms,
           overflow_new, overflow):
    h = T.shape[0]
    if h not in (3, 4) or T.shape != (h, h) or dT.shape != (h, h):
        raise ValueError(f"loop_commit: T and dT are [D+1, D+1] with D in "
                         f"(2, 3); got {tuple(T.shape)}, {tuple(dT.shape)}")
    if it.dtype != torch.int32 or it.shape != ():
        raise ValueError("loop_commit: `it` is a 0-d int32 tensor")
    if done.dtype != torch.bool or done.shape != ():
        raise ValueError("loop_commit: `done` is a 0-d bool tensor")
    if hist.dim() != 2 or hist.shape[1] != 2 or hist.shape[0] < 1:
        raise ValueError(f"loop_commit: `hist` is [S, 2], S >= 1; got "
                         f"{tuple(hist.shape)}")
    f32 = [dT, T, hist, overlap_new, overlap] + [
        x for x in (rms_new, rms) if x is not None]
    if any(x.dtype != torch.float32 for x in f32):
        raise ValueError("loop_commit: float32 transforms, window, overlap "
                         "and rms")
    if (rms_new is None) != (rms is None):
        raise ValueError("loop_commit: `rms_new` and `rms` go together")
    if (overflow_new is None) != (overflow is None):
        raise ValueError("loop_commit: `overflow_new` and `overflow` go "
                         "together")
    if overflow is not None and (overflow.dtype != torch.int64
                                 or overflow_new.dtype != torch.int64):
        raise ValueError("loop_commit: int64 overflow counts")
    tensors = [dT, T, it, done, hist, overlap_new, overlap] + [
        x for x in (rms_new, rms, overflow_new, overflow) if x is not None]
    if any(x.device != T.device for x in tensors):
        raise ValueError("loop_commit: every tensor on one device")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("loop_commit: contiguous tensors")
    return h - 1


def loop_commit_plain(dT, T, it, done, hist, overlap_new, overlap, *,
                      max_iter: int, rms_new=None, rms=None,
                      overflow_new=None, overflow=None, identity=False,
                      diff_checker=None, bound_checker=None) -> None:
    """:func:`loop_commit` in ordinary tensor operations, on whatever device
    the state lies (in place)."""
    d = _check(dT, T, it, done, hist, overlap_new, overlap, rms_new, rms,
               overflow_new, overflow)
    active = ~done & (it < max_iter)
    T_new = dT @ T
    step = torch.stack(_norm_and_angle(dT, d))
    hist_new = torch.cat([step[None], hist[:-1]])
    new_done = torch.full((), bool(identity), dtype=torch.bool,
                          device=T.device)
    if diff_checker is not None:
        min_t, min_r, smooth = diff_checker
        s = hist_new[0]
        for r in range(1, hist_new.shape[0]):
            s = s + hist_new[r]
        means = s / hist_new.shape[0]
        new_done = new_done | ((it + 1 >= smooth) & (means[0] < min_t)
                               & (means[1] < min_r))
    if bound_checker is not None:
        max_rot, max_trans = bound_checker
        norm, angle = _norm_and_angle(T_new, d)
        new_done = new_done | (angle > max_rot) | (norm > max_trans)
    T.copy_(torch.where(active, T_new, T))
    hist.copy_(torch.where(active, hist_new, hist))
    overlap.copy_(torch.where(active, overlap_new, overlap))
    if rms is not None:
        rms.copy_(torch.where(active, rms_new, rms))
    if overflow is not None:
        overflow.add_(torch.where(active, overflow_new,
                                  torch.zeros_like(overflow_new)))
    done.copy_(torch.where(active, new_done, done))
    it.add_(active.to(torch.int32))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def loop_commit(dT, T, it, done, hist, overlap_new, overlap, *,
                max_iter: int, rms_new=None, rms=None, overflow_new=None,
                overflow=None, identity=False, diff_checker=None,
                bound_checker=None, body: Optional[WhileBody] = None) -> None:
    """Commit one ICP iteration to the loop state ``(T, it, done, hist,
    overlap[, rms][, overflow])`` in place, from the increment ``dT`` and
    the iteration's ``overlap_new`` (and ``rms_new``; ``overflow_new`` is
    added on a matcher pass).  ``diff_checker`` is ``(min_t, min_r,
    smooth)``, ``bound_checker`` ``(max_rot, max_trans)``.  ``body``: the
    :class:`WhileBody` whose condition this commit sets (the last iteration
    of a WHILE node's body).  CUDA tensors launch ``csrc/graph_loop.cu``
    (or raise); CPU tensors run :func:`loop_commit_plain`."""
    if not T.is_cuda:
        if body is not None:
            raise ValueError("loop_commit: a WhileBody on the CPU (the CPU "
                             "runs the loop under Python)")
        loop_commit_plain(dT, T, it, done, hist, overlap_new, overlap,
                          max_iter=max_iter, rms_new=rms_new, rms=rms,
                          overflow_new=overflow_new, overflow=overflow,
                          identity=identity, diff_checker=diff_checker,
                          bound_checker=bound_checker)
        return
    d = _check(dT, T, it, done, hist, overlap_new, overlap, rms_new, rms,
               overflow_new, overflow)
    if body is not None and body.max_iter != int(max_iter):
        raise ValueError("loop_commit: the WHILE node tests another "
                         "max_iter")
    f32 = lambda x: float(np.float32(x))  # noqa: E731  (torch compares in f32)
    min_t, min_r, smooth = diff_checker or (0.0, 0.0, 0)
    max_rot, max_trans = bound_checker or (0.0, 0.0)
    lib = _lib()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.loop_commit_launch(
            dT.data_ptr(), T.data_ptr(), it.data_ptr(), done.data_ptr(),
            hist.data_ptr(), hist.shape[0], overlap_new.data_ptr(),
            overlap.data_ptr(), _ptr(rms_new), _ptr(rms), _ptr(overflow_new),
            _ptr(overflow), d, int(max_iter), int(bool(identity)),
            int(diff_checker is not None), f32(min_t), f32(min_r),
            int(smooth), int(bound_checker is not None), f32(max_rot),
            f32(max_trans), 0 if body is None else body.handle,
            int(body is not None), stream)
    if err != 0:
        raise RuntimeError(f"loop_commit kernel launch failed (code {err})")
    if body is not None:
        body.condition_set = True
    loop_commit.launches += 1
    loop_commit.launches_by_shape[(d,)] = \
        loop_commit.launches_by_shape.get((d,), 0) + 1


loop_commit.launches = 0  # kernel launches (the plain path adds none)
loop_commit.launches_by_shape = {}  # (D,) -> launches

from .tracing import StageTimer, trace, start_profiler, stop_profiler, \
    IterationInspector
from .checkpoint import save_checkpoint, load_checkpoint

__all__ = ["StageTimer", "trace", "start_profiler", "stop_profiler",
           "IterationInspector", "save_checkpoint", "load_checkpoint"]

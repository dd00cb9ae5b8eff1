"""Host ms blocked on the card per scan of the window: the ``wait.<cause>``
spans of ``PhaseTimer`` (host clock, one per wait that ``Mapper.waits``
counts), summed over the causes.  None where the program has no
``host.process_input`` span to hold them."""


def read(ctx):
    ms = ctx.phases_ms
    if "host.process_input" not in ms or not ctx.scans:
        return None
    return sum(v for k, v in ms.items() if k.startswith("wait.")) / ctx.scans

"""The host's own work per scan of the window, in ms: the spans
``host.process_input`` and ``host.input_filters`` of ``PhaseTimer`` (host
clock) less the ``wait.<cause>`` spans inside them."""


def read(ctx):
    ms = ctx.phases_ms
    if ("host.process_input" not in ms or "host.input_filters" not in ms
            or not ctx.scans):
        return None
    waited = sum(v for k, v in ms.items() if k.startswith("wait."))
    return (ms["host.process_input"] + ms["host.input_filters"]
            - waited) / ctx.scans

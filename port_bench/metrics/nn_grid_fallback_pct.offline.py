"""The grid matcher's queries sent to its exact brute-force fallback, as a
share of its valid queries over the window (percent):
``count.nn_grid_fallbacks`` over ``count.nn_grid_queries``, which the
Mapper adds to ``PhaseTimer`` at harvest from the solve's mirror.  None
where the program has no such counters."""


def read(ctx):
    ms = ctx.phases_ms
    queries = ms.get("count.nn_grid_queries")
    if not queries:
        return None
    return 100.0 * ms.get("count.nn_grid_fallbacks", 0) / queries

"""Executable-plan cache: hits over lookups in the window, from the
``plan_cache.hits`` and ``plan_cache.misses`` counters."""


def read(run):
    hits = run.delta("plan_cache.hits")
    lookups = hits + run.delta("plan_cache.misses")
    return hits / lookups if lookups else None

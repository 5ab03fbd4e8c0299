"""Pipeline executor and operators: device ms per completed query of the
ops launched inside ``agg.count_distinct`` spans (the sort of (group,
value) pairs of ``COUNT(DISTINCT)``, nested in ``sink.groupby``) on the
client's thread (``harness/attribution.py``).  None for a program without
that span."""
from bench_port.harness.attribution import ms_per_query


def read(run):
    return ms_per_query(run, lambda span: span["name"] == "agg.count_distinct")

"""Pipeline executor and operators: device ms per completed query of the
ops launched inside ``sink.orderby`` spans (``topk_select`` for ORDER BY
... LIMIT over integer keys, the generic sort where it declines) on the
client's thread (``harness/attribution.py``)."""
from bench_port.harness.attribution import ms_per_query


def read(run):
    return ms_per_query(run, lambda span: span["name"] == "sink.orderby")

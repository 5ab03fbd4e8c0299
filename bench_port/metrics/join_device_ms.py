"""Pipeline executor and operators: device ms per completed query of the
ops launched inside joins — ``op.join`` (an eager probe), ``sink.join``
(a build) and ``op.fused`` regions whose ``op`` lists a ``probe`` — on the
client's thread (``harness/attribution.py``)."""
from bench_port.harness.attribution import ms_per_query


def _join(span):
    name = span["name"]
    return name in ("op.join", "sink.join") or (
        name == "op.fused" and "probe" in span["attrs"].get("op", ""))


def read(run):
    return ms_per_query(run, _join)

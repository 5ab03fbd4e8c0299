"""SQL front end and optimizer: mean self time of the window's ``sql``
spans (``SiriusEngine.sql``) less their ``engine.execute`` children, ms:
lexing, parsing, binding, optimizing, or the text key's lookup on a hit."""
from statistics import mean

from bench_port.harness.spans import self_time


def read(run):
    times = self_time(run.spans, "sql", "engine.execute")
    return mean(times) * 1e3 if times else None

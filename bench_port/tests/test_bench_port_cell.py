"""Whole runs on the CPU at a tiny scale: each cell comes out correct,
and comes out not correct with its timed path broken underneath (an
answer altered where the engine produces it, half of an answer's rows
left out) or with the control (the reference in float32) in the engine's
place.  The harness's look for a card is skipped (``device="cpu"``)."""
import pytest
import torch

from bench_port.control import control_answer
from bench_port.harness import cell, spec
from repro_torch.core.executor import SiriusEngine
from repro_torch.relational.table import Column, Table

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SCALE = 0.01


def run(name, **kw):
    return cell.run(name, 2**31 + 21, 1.0, False, device="cpu",
                    scale=SCALE, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"queries_per_s", "query_p95_ms", "setup_s"} == set(res["metrics"])


def _altered(table: Table) -> Table:
    cols = dict(table.columns)
    name = next((n for n, c in cols.items() if c.kind == "numeric"), None)
    if name is None or table.num_rows == 0:
        return table
    data = cols[name].data.clone()
    data[0] += 1
    cols[name] = Column(data, cols[name].kind, cols[name].dictionary)
    return Table(cols)


def _halved(table: Table) -> Table:
    return table.head(table.num_rows // 2) if table.num_rows > 1 else table


@pytest.mark.parametrize("fault", [_altered, _halved], ids=["altered", "half"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    real = SiriusEngine.sql
    monkeypatch.setattr(SiriusEngine, "sql",
                        lambda self, *a, **k: fault(real(self, *a, **k)))
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["mismatched"]["value"] > 0 or \
        res["checks"]["float_err"]["value"] > res["checks"]["float_err"]["limit"]


# float32's error grows with the rows summed: at SF 1 the control reads
# about 8x the limit on the CPU (0.045 at SF 10 on the card)
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    res = cell.run(name, 2**31 + 21, 0.5, False, device="cpu",
                   scale=1.0, answer=control_answer(name))
    assert not res["correct"]
    assert res["checks"]["float_err"]["value"] > res["checks"]["float_err"]["limit"]


def test_a_failed_query_is_counted_and_not_correct(monkeypatch):
    real = SiriusEngine.sql
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 30:
            raise RuntimeError("injected")
        return real(self, *a, **k)
    monkeypatch.setattr(SiriusEngine, "sql", flaky)
    res = run("tpch-sf10.power-hot")
    assert res["failed"] == 1 and not res["correct"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit):
        cell.run("tpch-sf10.power-hot", 1, 1.0, False)

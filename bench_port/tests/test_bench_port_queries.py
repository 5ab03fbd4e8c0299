"""The frozen query texts: the validation values give the port's texts
back, Q11's FRACTION follows the scale as clause 2.4.11.3 sets it, and
the generator's passes are permutations drawn from the seed."""
import itertools

import pytest

from bench_port.datagen import tpch as gen
from bench_port.harness.traffic import Stream
from bench_port.queries import tpch as q
from bench_port.reference.tpch import Reference
from repro_torch.data.tpch_queries import SQL_QUERIES


def test_validation_values_give_the_ports_texts():
    for qid in q.IDS:
        assert q.text(qid, q.VALIDATION[qid]) == SQL_QUERIES[qid], qid
        assert q.parameters(qid, 1) == q.VALIDATION[qid], qid


@pytest.mark.parametrize("scale, fraction", [(1, "0.0001"), (10, "0.00001"),
                                             (30, "0.0000033333333333333333"),
                                             (0.01, "0.01")])
def test_q11_fraction_is_0_0001_over_sf(scale, fraction):
    p = q.parameters(11, scale)
    assert p["fraction"] == pytest.approx(0.0001 / scale)
    assert f"* {fraction}\n" in q.text(11, p)
    for qid in q.IDS:
        if qid != 11:
            assert q.text(qid, q.parameters(qid, scale)) == SQL_QUERIES[qid]


def test_q11_returns_rows_at_the_scaled_fraction():
    """The spec's Q11 keeps the parts above 0.0001 / SF of the nation's
    stock value: some rows, not all of the nation's parts.  At SF 0.1:
    at SF 0.01 no part's value reaches the threshold."""
    sf = 0.1
    ds = gen.generate(sf, 2**31 + 7, "cpu")
    ans = Reference(ds).run(11, q.slots(11, q.parameters(11, sf)))
    german_parts = 4 * ds.rows("part") / 25
    assert 0 < len(ans["ps_partkey"]) < german_parts


def _window(seed, n, queries=q):
    return list(itertools.islice(Stream({"warm_passes": 1}, queries, seed, 10).window(), n))


def test_each_pass_runs_every_query_once():
    s = Stream({"warm_passes": 2}, q, 9, 10)
    warm = s.warm()
    assert len(warm) == 2 * len(q.IDS)
    window = _window(9, 3 * len(q.IDS))
    for part in (warm, window):
        for i in range(len(part) // len(q.IDS)):
            ids = [x[0] for x in part[i * 22:(i + 1) * 22]]
            assert sorted(ids) == list(q.IDS)
    assert window[:22] != warm[:22]
    assert dict(window)[11]["fraction"] == pytest.approx(0.00001)


def test_passes_repeat_from_the_seed():
    assert _window(3, 60) == _window(3, 60)
    assert _window(3, 60) != _window(4, 60)


def test_column_lists():
    assert q.columns(6) == [("lineitem", c) for c in
                            ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")]
    assert ("orders", "o_comment") in q.columns(13)
    assert q.columns(11) == [("nation", "n_nationkey"), ("nation", "n_name"),
                             ("supplier", "s_suppkey"), ("supplier", "s_nationkey"),
                             ("partsupp", "ps_partkey"), ("partsupp", "ps_suppkey"),
                             ("partsupp", "ps_availqty"), ("partsupp", "ps_supplycost")]

"""ClickBench's ``hits`` generator and query texts, on the CPU: the
engine's dtypes, one table per seed, the official distinct counts scaled
to the rows, sorted dictionaries, and the 13 queries shared with the
port's ClickBench set in its texts."""
import re

import numpy as np
import pytest
import torch

from bench_port.datagen import clickbench as gen
from bench_port.queries import clickbench as q
from repro_torch.data.clickbench import CLICKBENCH_QUERIES

SEED = 2**31 + 13


@pytest.fixture(scope="module", params=[0.01, 1.0], ids=["10k", "1M"])
def db(request):
    return request.param, gen.generate(request.param, SEED, "cpu")


def test_the_engines_columnar_form(db):
    scale, ds = db
    n = round(scale * 1e6)
    assert ds.rows("hits") == n
    assert sorted(ds.tables["hits"]) == sorted(q.SCHEMA["hits"])
    strings = {"url", "title", "searchphrase", "mobilephonemodel"}
    for c, v in ds.tables["hits"].items():
        kind = ds.kinds["hits"][c]
        assert v.shape == (n,)
        if c in strings:
            assert kind == "string" and v.dtype == torch.int32
        elif c == "eventdate":
            assert kind == "date" and v.dtype == torch.int32
        else:
            assert kind == "numeric" and v.dtype == torch.int64
    assert ds.nbytes() == 92 * n


def test_distinct_counts_follow_the_rows(db):
    scale, ds = db
    n = round(scale * 1e6)
    h = ds.tables["hits"]

    def distinct(c):
        return torch.unique(h[c]).numel()
    assert distinct("userid") == gen.scaled(gen.USERS, n)
    assert distinct("searchphrase") == gen.scaled(gen.PHRASES, n)
    assert distinct("url") == gen.scaled(gen.URLS, n)
    assert distinct("title") == gen.scaled(gen.TITLES, n)
    assert distinct("mobilephonemodel") <= gen.MODELS + 1
    assert distinct("watchid") >= n * (1 - 2 * gen.REPEATS)
    assert gen.scaled(gen.USERS, gen.FULL_ROWS) == 17_630_976
    assert gen.scaled(gen.PHRASES, gen.FULL_ROWS) == 6_019_103


def test_dictionaries_are_sorted_and_hold_what_is_used(db):
    _, ds = db
    for c, d in ds.dictionaries["hits"].items():
        assert np.all(d[:-1] < d[1:]), c
        codes = ds.tables["hits"][c]
        assert int(codes.min()) == 0 and int(codes.max()) == len(d) - 1, c
    hosts = gen.hosts()
    assert not any(b.startswith(a) for a, b in zip(hosts, hosts[1:]))
    assert ds.dictionaries["hits"]["searchphrase"][0] == ""
    assert ds.dictionaries["hits"]["mobilephonemodel"][0] == ""


def test_the_shapes_the_queries_probe(db):
    scale, ds = db
    h = ds.tables["hits"]
    d = ds.dictionaries["hits"]
    n = ds.rows("hits")
    assert int((h["userid"] == q.Q19_USERID).sum()) >= 1
    assert bool((h["userid"] >= 0).all())
    empty = float((h["searchphrase"] == 0).double().mean())
    assert abs(empty - (1 - gen.PHRASE_SHARE)) < 0.01
    google = np.char.find(d["url"], "google") >= 0
    share = float(torch.from_numpy(google)[h["url"].long()].double().mean())
    assert share < 1e-3
    days = h["eventdate"] - gen.DAY0
    assert int(days.min()) >= 0 and int(days.max()) <= 30
    assert 0 < float((h["advengineid"] != 0).double().mean()) < 0.02


def test_one_table_per_seed():
    a = gen.generate(0.01, SEED, "cpu")
    b = gen.generate(0.01, SEED, "cpu")
    c = gen.generate(0.01, SEED + 1, "cpu")
    for col, v in a.tables["hits"].items():
        assert torch.equal(v, b.tables["hits"][col])
    for col, d in a.dictionaries["hits"].items():
        assert np.array_equal(d, b.dictionaries["hits"][col])
    assert not torch.equal(a.tables["hits"]["userid"], c.tables["hits"]["userid"])


def _plain(text):
    return " ".join(text.split()).lower()


def test_shared_queries_are_the_ports_texts():
    """The 13 queries the port's ClickBench set also has are its texts,
    whitespace aside."""
    shared = sorted(set(q.IDS) & set(CLICKBENCH_QUERIES), key=q.IDS.index)
    assert shared == ["q0", "q1", "q2", "q4", "q5", "q6", "q8", "q10", "q12",
                      "q14", "q20", "q21", "q22"]
    for qid in shared:
        assert _plain(q.text(qid, {})) == _plain(CLICKBENCH_QUERIES[qid]), qid


def test_the_query_set():
    want = [f"q{i}" for i in list(range(18)) + [19, 20, 21, 22] + list(range(30, 36))]
    assert list(q.IDS) == want
    for qid in q.IDS:
        assert q.parameters(qid, 99.997497) == {} and q.slots(qid, {}) == {}
        text = q.text(qid, {})
        if " limit " in _plain(text):
            assert " order by " in _plain(text), qid
        cols = q.columns(qid)
        assert (qid == "q0") == (not cols), qid      # count(*) reads no column
        assert all(t == "hits" for t, _ in cols)
        assert {c for _, c in cols} <= set(re.findall(r"[a-z_]+", text.lower()))
    assert [c for _, c in q.columns("q31")] == ["watchid", "clientip", "resolutionwidth",
                                                 "isrefresh", "searchphrase"]

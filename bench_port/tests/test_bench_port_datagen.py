"""The device generators, run on the CPU at a tiny scale: row counts, key
ranges and foreign keys as their sources imply, one database per seed,
and the engine's columnar form."""
import numpy as np
import pytest
import torch

from bench_port.datagen import encode, tpch

SF = 0.01
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def db():
    return tpch.generate(SF, SEED, "cpu")


def col(ds, t, c):
    return ds.tables[t][c].numpy()


def strings(ds, t, c):
    return ds.dictionaries[t][c][col(ds, t, c)]


def order_row(ds):
    """Row in orders of each lineitem row."""
    return np.searchsorted(col(ds, "orders", "o_orderkey"), col(ds, "lineitem", "l_orderkey"))


def test_tpch_row_counts(db):
    rows = {t: db.rows(t) for t in db.tables}
    assert rows["region"] == 5 and rows["nation"] == 25
    assert rows["supplier"] == 100 and rows["part"] == 2000
    assert rows["partsupp"] == 4 * rows["part"]
    assert rows["customer"] == 1500 and rows["orders"] == 15000
    assert rows["orders"] <= rows["lineitem"] <= 7 * rows["orders"]


def test_tpch_dtypes_are_the_engines(db):
    for t, cols in db.tables.items():
        for c, v in cols.items():
            kind = db.kinds[t][c]
            if kind in ("string", "date"):
                assert v.dtype == torch.int32, (t, c)
            else:
                assert v.dtype in (torch.int64, torch.float64), (t, c)


def test_tpch_keys_and_foreign_keys(db):
    ok = col(db, "orders", "o_orderkey")
    i = np.arange(1, len(ok) + 1)
    assert (ok == (i // 8) * 32 + i % 8).all()      # dbgen's mk_sparse
    assert list(ok[:9]) == [1, 2, 3, 4, 5, 6, 7, 32, 33]
    assert (col(db, "orders", "o_custkey") % 3 != 0).all()
    assert np.isin(col(db, "lineitem", "l_orderkey"), ok).all()
    lp, ls = col(db, "lineitem", "l_partkey"), col(db, "lineitem", "l_suppkey")
    assert lp.min() >= 1 and lp.max() <= db.rows("part")
    assert ls.min() >= 1 and ls.max() <= db.rows("supplier")
    pp, psk = col(db, "partsupp", "ps_partkey"), col(db, "partsupp", "ps_suppkey")
    ps = set(zip(pp.tolist(), psk.tolist()))
    assert len(ps) == len(pp)
    assert all((p, s) in ps for p, s in zip(lp.tolist(), ls.tolist()))
    per_part = np.bincount(pp)[1:]
    assert (per_part == 4).all()
    assert (np.diff(pp) >= 0).all()
    assert set(col(db, "nation", "n_regionkey")) <= set(col(db, "region", "r_regionkey"))


def test_tpch_dates_and_flags(db):
    odate = col(db, "orders", "o_orderdate")
    oi = order_row(db)
    ship, commit = col(db, "lineitem", "l_shipdate"), col(db, "lineitem", "l_commitdate")
    receipt = col(db, "lineitem", "l_receiptdate")
    assert ((ship - odate[oi] >= 1) & (ship - odate[oi] <= 121)).all()
    assert ((commit - odate[oi] >= 30) & (commit - odate[oi] <= 90)).all()
    assert ((receipt - ship >= 1) & (receipt - ship <= 30)).all()
    rf = strings(db, "lineitem", "l_returnflag")
    assert ((rf == "N") == (receipt > tpch.CURRENTDATE)).all()
    ls = strings(db, "lineitem", "l_linestatus")
    assert ((ls == "O") == (ship > tpch.CURRENTDATE)).all()
    status = strings(db, "orders", "o_orderstatus")
    open_lines = np.bincount(oi, ls == "O", len(odate))
    lines = np.bincount(oi, minlength=len(odate))
    assert ((status == "F") == (open_lines == 0)).all()
    assert ((status == "O") == (open_lines == lines)).all()
    ln = col(db, "lineitem", "l_linenumber")
    assert ln.min() == 1 and ln.max() <= 7


def test_tpch_money(db):
    ext = col(db, "lineitem", "l_extendedprice")
    qty = col(db, "lineitem", "l_quantity")
    retail = col(db, "part", "p_retailprice")[col(db, "lineitem", "l_partkey") - 1]
    assert np.allclose(ext, np.round(qty * retail, 2))
    disc, tax = col(db, "lineitem", "l_discount"), col(db, "lineitem", "l_tax")
    net = ext * (1 - disc) * (1 + tax)
    oi = order_row(db)
    total = np.bincount(oi, net, db.rows("orders"))
    assert np.allclose(col(db, "orders", "o_totalprice"), np.round(total, 2), atol=0.011)
    assert set(np.round(disc * 100).astype(int)) <= set(range(11))


def test_tpch_strings(db):
    for t, dicts in db.dictionaries.items():
        for c, d in dicts.items():
            assert (np.sort(d) == d).all() and len(np.unique(d)) == len(d), (t, c)
            codes = col(db, t, c)
            assert codes.min() >= 0 and codes.max() < len(d)
    phones = strings(db, "customer", "c_phone")
    cc = np.array([int(p[:2]) for p in phones])
    assert (cc == col(db, "customer", "c_nationkey") + 10).all()
    assert any("special" in s and "requests" in s.split("special", 1)[1]
               for s in db.dictionaries["orders"]["o_comment"])
    assert any(s.startswith("take Customer") and s.endswith("Complaints against")
               for s in db.dictionaries["supplier"]["s_comment"])
    names = strings(db, "part", "p_name")
    assert all(len(n.split()) == 5 for n in names[:50])
    assert strings(db, "supplier", "s_name")[0] == "Supplier#000000001"


def test_one_seed_one_database():
    a, b = tpch.generate(SF, 7, "cpu"), tpch.generate(SF, 7, "cpu")
    c = tpch.generate(SF, 8, "cpu")
    for t in a.tables:
        for k in a.tables[t]:
            assert torch.equal(a.tables[t][k], b.tables[t][k]), (t, k)
    assert not torch.equal(a.tables["lineitem"]["l_partkey"][:100],
                           c.tables["lineitem"]["l_partkey"][:100])


def test_encode_matches_np_unique():
    tok = torch.tensor([5, 3, 5, 9, 3, 1])
    names = {1: "b", 3: "a", 5: "c", 9: "a2"}
    codes, d = encode.encode(tok, lambda t: [names[int(x)] for x in t], ordered=False)
    want_d, want_codes = np.unique([names[int(x)] for x in tok], return_inverse=True)
    assert list(d) == list(want_d) and codes.tolist() == want_codes.tolist()


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_word_tokens_sort_as_their_strings(k):
    words = sorted(tpch.P_WORDS)
    tok = np.sort(np.random.default_rng(k).integers(0, len(words) ** k, 300))
    out = list(encode.words_render(words, k)(tok))
    assert out == sorted(out)

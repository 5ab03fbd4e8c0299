"""The port's relational layer against the JAX package, on the CPU.

Tables, expression evaluation (values *and* dtypes, so the reference's x64
promotion is kept), joins of all five kinds, group-by aggregation, sorting
and the string subsystem.  The same numpy arrays, made from a seed, go
into ``repro`` and ``repro_torch``; results are compared on the host.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

import repro.relational as jrel
from repro.relational import aggregate as jagg
from repro.relational import expressions as jex
from repro.relational import join as jjoin
from repro.relational import sort as jsort
from repro.relational.table import Column as JColumn, Table as JTable
from repro_torch.relational import aggregate as tagg
from repro_torch.relational import expressions as tex
from repro_torch.relational import join as tjoin
from repro_torch.relational import sort as tsort
from repro_torch.relational.table import Column, Table, unify_string_keys

from conftest import assert_tables_equal

# the suite runs files in parallel worker processes: keep torch to one
# thread so the workers do not oversubscribe the cores
torch.set_num_threads(1)

N_ROWS = 500


def _data(seed=0, n=N_ROWS):
    rng = np.random.default_rng(seed)
    words = np.array(["apple", "apricot", "banana", "cherry", "date", "fig",
                      "grape", "kiwi", "lemon", "mango", "", "a%b"])
    return {
        "k": rng.integers(0, 40, n).astype(np.int64),
        "k2": rng.integers(-3, 4, n).astype(np.int64),
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "x": np.round(rng.normal(100, 30, n), 2),
        "f32": rng.normal(size=n).astype(np.float32),
        "d": np.datetime64("1960-01-01") + rng.integers(0, 30000, n).astype("timedelta64[D]"),
        "s": words[rng.integers(0, len(words), n)],
        "b": rng.random(n) < 0.4,
    }


def both(data):
    return Table.from_pydict(data), JTable.from_pydict(data)


def _dt(a):
    return str(a.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


def test_from_pydict_same_codes_dictionaries_and_dtypes():
    t, j = both(_data(1))
    for name in j.column_names:
        tc, jc = t[name], j[name]
        assert tc.kind == jc.kind
        assert _dt(tc.data) == str(jc.data.dtype)
        np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
        if jc.dictionary is not None:
            np.testing.assert_array_equal(tc.dictionary, jc.dictionary)
    assert_tables_equal(t.to_host(), j.to_host(), rtol=0, atol=0)


def test_take_filter_head_concat_match_reference():
    data = _data(2)
    t, j = both(data)
    idx = np.random.default_rng(0).integers(0, N_ROWS, 77)
    assert_tables_equal(t.take(torch.from_numpy(idx)).to_host(),
                        j.take(idx).to_host(), rtol=0, atol=0)
    mask = data["x"] > 100
    assert_tables_equal(t.filter_mask(torch.from_numpy(mask)).to_host(),
                        j.filter_mask(mask).to_host(), rtol=0, atol=0)
    assert_tables_equal(t.head(5).to_host(), j.head(5).to_host(), rtol=0, atol=0)
    other = _data(3, 60)
    other["s"] = np.array(["zebra", "apple", "yak"] * 20)
    t2, j2 = both(other)
    got, want = Table.concat([t, t2]), JTable.concat([j, j2])
    np.testing.assert_array_equal(got["s"].dictionary, want["s"].dictionary)
    np.testing.assert_array_equal(got["s"].data.numpy(), np.asarray(want["s"].data))
    assert_tables_equal(got.to_host(), want.to_host(), rtol=0, atol=0)


def test_recode_and_unify_string_keys():
    a = Column.from_strings(["x", "b", "a", "x"])
    b = Column.from_strings(["b", "c", "x"])
    ja = JColumn.from_strings(["x", "b", "a", "x"])
    jb = JColumn.from_strings(["b", "c", "x"])
    (ua, ub), (jua, jub) = unify_string_keys(a, b), jrel.unify_string_keys(ja, jb)
    for got, want in ((ua, jua), (ub, jub)):
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.dictionary, want.dictionary)
    np.testing.assert_array_equal(
        a.recode_to(b.dictionary).data.numpy(),
        np.asarray(ja.recode_to(jb.dictionary).data))


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------


def _exprs(m):
    """The same expression built from module ``m`` (repro or repro_torch)."""
    C, L = m.Col, m.Lit
    return [
        C("x") * (L(1.0) - C("f32")),
        C("i32") + L(5),                      # weak int literal: stays int32
        L(5) - C("i32"),
        C("i32") + L(0.5),                    # float literal lifts int to f64
        C("f32") * L(2.0),                    # float literal: strong f64
        C("k") + C("i32"),
        C("k") / C("k2"),
        L(3) / C("x"),
        C("d") + L(7),
        C("d") - C("d"),
        C("d") < m.DateLit("1980-06-01"),
        C("x") >= L(100),
        C("k") == C("k2"),
        (C("k") < L(10)) & ~(C("b")) | (C("x") > L(150.0)),
        m.Between(C("x"), L(90.0), L(110.0)),
        m.Between(C("i32"), C("k2"), L(20)),
        m.InList(C("k"), [1, 5, 39]),
        m.InList(C("s"), ["fig", "kiwi", "nope"], negate=True),
        m.Like(C("s"), "ap%"),
        m.Like(C("s"), "banana"),
        m.Like(C("s"), "%an%"),
        m.Like(C("s"), "a\\%b"),
        m.Like(C("s"), "_i%", negate=True),
        m.StartsWith(C("s"), "ch"),
        C("s") == L("fig"),
        C("s") == L("absent"),
        C("s") != L("absent"),
        C("s") < L("cherry"),
        C("s") <= L("cherry"),
        C("s") > L("c"),
        C("s") >= L("date"),
        L("grape") > C("s"),
        m.Case([(C("x") > L(120.0), C("x")), (C("b"), L(0.0))], L(-1.0)),
        m.ExtractYear(C("d")),
        m.Substr(C("s"), 2, 3),
        m.Cast(C("i32"), "float64"),
        m.Cast(C("x"), "int64"),
        m.UnOp("-", C("x")),
        m.UnOp("not", C("b")),
        L(7),
        L(2.5),
    ]


@pytest.mark.parametrize("i", range(len(_exprs(tex))))
def test_evaluate_matches_reference_values_and_dtypes(i):
    t, j = both(_data(4))
    got = tex.evaluate(_exprs(tex)[i], t)
    want = jex.evaluate(_exprs(jex)[i], j)
    assert got.kind == want.kind
    assert _dt(got.data) == str(want.data.dtype), (_dt(got.data), want.data.dtype)
    g, w = got.data.numpy(), np.asarray(want.data)
    if want.kind == "string":
        np.testing.assert_array_equal(got.dictionary, want.dictionary)
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=1e-12, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, w)


def test_expression_structural_helpers():
    e = tex.Col("a") + tex.Lit(1)
    f = tex.Col("a") + tex.Lit(1)
    assert isinstance(e == f, tex.BinOp)        # the trap: == builds a node
    assert e.equals(f) and tex.expr_equal(e, f)
    assert not e.equals(tex.Col("a") + tex.Lit(2))
    assert [type(x).__name__ for x in tex.walk_expr(e)] == ["BinOp", "Col", "Lit"]
    g = tex.transform_expr(e, lambda n: tex.Col("b") if isinstance(n, tex.Col) else n)
    assert g.columns() == ["b"] and e.columns() == ["a"]


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def _join_inputs(seed):
    rng = np.random.default_rng(seed)
    probe = {"pk": rng.integers(0, 30, 200).astype(np.int64),
             "pk2": rng.integers(0, 3, 200).astype(np.int64),
             "ps": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, 200)],
             "pf": rng.integers(0, 5, 200) * 0.5,
             "pv": rng.normal(size=200)}
    build = {"bk": rng.integers(0, 30, 60).astype(np.int64),
             "bk2": rng.integers(0, 3, 60).astype(np.int64),
             "bs": np.array(["b", "c", "e"])[rng.integers(0, 3, 60)],
             "bf": rng.integers(0, 5, 60) * 0.5,
             "bv": rng.integers(0, 1000, 60).astype(np.int64)}
    return probe, build


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "mark"])
@pytest.mark.parametrize("keys", [(["pk"], ["bk"]), (["pk", "pk2"], ["bk", "bk2"]),
                                  (["ps"], ["bs"]), (["pf"], ["bf"])])
def test_hash_join_matches_reference(how, keys):
    probe, build = _join_inputs(len(keys[0]) * 7 + len(how))
    tp, jp = both(probe)
    tb, jb = both(build)
    got = tjoin.hash_join(tp, tb, keys[0], keys[1], how).to_host()
    want = jjoin.hash_join(jp, jb, keys[0], keys[1], how).to_host()
    if how == "left":     # unmatched rows carry garbage build values
        m = want["__matched"]
        for k in build:
            got[k], want[k] = got[k][m], want[k][m]
    assert_tables_equal(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "mark"])
def test_hash_join_empty_sides_match_reference(how):
    probe, build = _join_inputs(9)
    tp, jp = both(probe)
    tb, jb = both(build)
    empty_t, empty_j = tb.head(0), jb.head(0)
    got = tjoin.hash_join(tp, empty_t, ["pk"], ["bk"], how).to_host()
    want = jjoin.hash_join(jp, empty_j, ["pk"], ["bk"], how).to_host()
    assert_tables_equal(got, want, rtol=0, atol=0)
    if how in ("inner", "left"):
        got = tjoin.hash_join(tp.head(0), tb, ["pk"], ["bk"], how).to_host()
        want = jjoin.hash_join(jp.head(0), jb, ["pk"], ["bk"], how).to_host()
        assert_tables_equal(got, want, rtol=0, atol=0)


def test_combine_keys_packs_like_reference():
    probe, build = _join_inputs(3)
    tp, jp = both(probe)
    tb, jb = both(build)
    pk, bk = tjoin.combine_keys([tp["pk"], tp["pk2"]], [tb["bk"], tb["bk2"]])
    jpk, jbk = jjoin.combine_keys([jp["pk"], jp["pk2"]], [jb["bk"], jb["bk2"]])
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jbk))


# ---------------------------------------------------------------------------
# group-by aggregation
# ---------------------------------------------------------------------------


def _aggs(m, AggSpec):
    C = m.Col
    return [AggSpec("sum", C("x"), "sx"), AggSpec("sum", C("i32"), "si"),
            AggSpec("sum", C("b"), "sb"), AggSpec("sum", C("f32"), "sf"),
            AggSpec("avg", C("x"), "ax"), AggSpec("count", C("x"), "c"),
            AggSpec("count_star", None, "cs"), AggSpec("min", C("x"), "mnx"),
            AggSpec("max", C("i32"), "mxi"), AggSpec("min", C("s"), "mns"),
            AggSpec("max", C("d"), "mxd")]


@pytest.mark.parametrize("keys", [[], ["k"], ["k2", "s"], ["d"], ["k", "d", "s"],
                                  ["x"], ["b", "k2"]])
def test_group_aggregate_matches_reference(keys):
    t, j = both(_data(5))
    got = tagg.group_aggregate(t, keys, _aggs(tex, tagg.AggSpec))
    want = jagg.group_aggregate(j, keys, _aggs(jex, jagg.AggSpec))
    assert got.column_names == want.column_names
    assert_tables_equal(got.to_host(), want.to_host())


@pytest.mark.parametrize("keys", [["k"], ["k2", "s"]])
def test_count_distinct_matches_reference(keys):
    t, j = both(_data(6))
    got = tagg.group_aggregate(t, keys, [tagg.AggSpec("count_distinct", tex.Col("i32"), "cd")])
    want = jagg.group_aggregate(j, keys, [jagg.AggSpec("count_distinct", jex.Col("i32"), "cd")])
    assert_tables_equal(got.to_host(), want.to_host(), rtol=0, atol=0)


def test_group_aggregate_empty_input_matches_reference():
    t, j = both(_data(7))
    got = tagg.group_aggregate(t.head(0), ["k"], _aggs(tex, tagg.AggSpec)[:3])
    want = jagg.group_aggregate(j.head(0), ["k"], _aggs(jex, jagg.AggSpec)[:3])
    assert_tables_equal(got.to_host(), want.to_host())


@pytest.mark.parametrize("keys", [["k"], ["k2", "s"], ["x", "k"]])
def test_factorize_groups_matches_reference(keys):
    t, j = both(_data(8))
    gids, uniq = tagg.factorize_groups(t, keys)
    jg, ju = jagg.factorize_groups(j, keys)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(jg))
    assert_tables_equal(uniq.to_host(), ju.to_host(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,limit", [
    ([("k", True)], None), ([("k2", False), ("s", True)], None),
    ([("x", False)], 10), ([("b", True), ("d", False), ("i32", True)], 50),
    ([("s", False), ("k", True), ("x", True)], None), ([("f32", True)], 3)])
def test_sort_table_matches_reference(spec, limit):
    t, j = both(_data(10))
    got = tsort.sort_table(t, [tsort.SortKey(n, a) for n, a in spec], limit)
    want = jsort.sort_table(j, [jsort.SortKey(n, a) for n, a in spec], limit)
    assert_tables_equal(got.to_host(), want.to_host(), rtol=0, atol=0)


def test_string_artifacts_are_cached_by_dictionary_identity():
    from repro_torch.relational import strings
    d = np.array(["ab", "ac", "b"])
    m1 = strings.like_mask(d, "a%c", "cpu")
    before = dict(strings.stats)
    m2 = strings.like_mask(d, "a%c", "cpu")
    assert m1 is m2 and strings.stats["cache_hits"] == before["cache_hits"] + 1
    assert m1.tolist() == [False, True, False]
    derived, remap = strings.substr_transform(d, 1, 1, "cpu")
    assert strings.substr_transform(d, 1, 1, "cpu")[0] is derived
    assert derived.tolist() == ["a", "b"] and remap.tolist() == [0, 0, 1]


def test_buffer_manager_spills_and_promotes_like_reference():
    from repro.buffer.manager import BufferManager as JBuffers
    from repro_torch.buffer.manager import BufferError, BufferManager
    a, ja = both(_data(11))
    b, jb = both(_data(12))
    budget = a.nbytes + b.nbytes - 1          # room for one table at a time
    mine, ref = BufferManager(budget, 1 << 20, "cpu"), JBuffers(budget, 1 << 20)
    for bufs, x, y in ((mine, a, b), (ref, ja, jb)):
        bufs.cache_table("a", x)
        bufs.cache_table("b", y)               # spills "a"
        bufs.get("a")                          # promotes "a", spills "b"
    assert mine.stats() == {k: v for k, v in ref.stats().items()
                            if not k.startswith("boundary")}
    assert mine.table_epochs == ref.table_epochs == {"a": 1, "b": 1}
    assert_tables_equal(mine.get("a").to_host(), ja.to_host(), rtol=0, atol=0)
    with pytest.raises(BufferError):
        mine.alloc_processing(2 << 20)


# ---------------------------------------------------------------------------
# order-free float sums (the card's generic group-by) and the kernel route's
# centring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["money", "integer", "normal", "wide"])
def test_fixed_point_segment_sum_is_order_free_and_close(kind):
    """What the card's generic group-by sums floats with, run here on CPU
    tensors: one answer in any row order (bitwise), integer-valued columns
    exact, and within 1e-11 of float64 ``index_add_`` relative to the sum
    of magnitudes."""
    rng = np.random.default_rng(7)
    n, g = 50_000, 900
    ids = torch.from_numpy(rng.integers(0, g, n))
    x = {"money": rng.integers(90_000, 10_494_950, n) / 100.0,
         "integer": rng.integers(1, 51, n).astype(np.float64),
         "normal": rng.normal(size=n),
         "wide": rng.normal(size=n) * 10.0 ** rng.integers(-3, 9, n)}[kind]
    x = torch.from_numpy(x)
    got = tagg.fixed_point_segment_sum(x, ids, g + 3)
    perm = torch.from_numpy(rng.permutation(n))
    assert torch.equal(got, tagg.fixed_point_segment_sum(x[perm], ids[perm],
                                                         g + 3))
    want = torch.zeros(g + 3, dtype=torch.float64).index_add_(0, ids, x)
    scale = torch.zeros(g + 3, dtype=torch.float64).index_add_(0, ids, x.abs())
    assert bool(((got - want).abs() <= 1e-11 * scale).all())
    if kind == "integer":
        assert torch.equal(got, want)
    assert (got[g:] == 0).all()                  # empty segments


def test_fixed_point_segment_sum_non_finite_values():
    inf, nan = float("inf"), float("nan")
    x = torch.tensor([1.0, inf, 2.0, nan, -inf, 3.0, inf, -inf, 5.0],
                     dtype=torch.float64)
    ids = torch.tensor([0, 1, 0, 2, 3, 3, 5, 5, 1])
    got = tagg.fixed_point_segment_sum(x, ids, 7)
    want = torch.zeros(7, dtype=torch.float64).index_add_(0, ids, x)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])
    empty = tagg.fixed_point_segment_sum(x[:0], ids[:0], 2)
    assert torch.equal(empty, torch.zeros(2, dtype=torch.float64))


def test_kernel_route_sums_integer_valued_columns_exactly():
    """The group-by kernel route centres each column on its mean rounded to
    an integer, so group sums of an integer-valued float column (Q18's
    l_quantity) are exact and a HAVING on them (sum > 300) sees the exact
    value.  The reference centres on the mean itself, and its sums miss
    by up to ~6e-5 on these inputs (ROADMAP.md queue 3)."""
    from repro.core.kernel_backend import KernelBackend as JBackend
    from repro_torch.core.kernel_backend import KernelBackend
    rng = np.random.default_rng(0)
    n = 60_000
    data = {"g": rng.integers(0, 5000, n),
            "q": rng.integers(1, 51, n).astype(np.float64)}
    t, jt = both(data)
    spec = [tagg.AggSpec("sum", tex.Col("q"), "s")]
    got = KernelBackend().try_aggregate(t, ["g"], spec).to_host()
    exact = tagg.group_aggregate(t, ["g"], spec).to_host()
    np.testing.assert_array_equal(got["s"], exact["s"])
    assert (exact["s"] == 300).sum() > 0
    ref = JBackend().try_aggregate(
        jt, ["g"], [jagg.AggSpec("sum", jex.Col("q"), "s")]).to_host()
    assert np.abs(np.asarray(ref["s"]) - exact["s"]).max() > 0

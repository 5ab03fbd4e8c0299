"""The port's string subsystem against ``tests/test_strings.py``'s 15 cases.

Each case of the reference's string tests, run on ``repro_torch``'s
``relational/strings.py`` (CPU tensors): LIKE semantics against the same
independent recursive matcher and against the reference's own results
(row-exact), the prefix / exact fast paths, substring and IN, identity
stability of derived and merged dictionaries, the host pass memoized per
(dictionary, pattern), dictionary-informed selectivity and the join order
it changes, and ``starts_with`` against a prefix LIKE in SQL.
"""
import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch

from repro.relational import expressions as jex
from repro.relational.table import Table as JTable
from repro_torch.relational import strings
from repro_torch.relational.expressions import (
    Col, InList, Like, StartsWith, Substr, evaluate,
)
from repro_torch.relational.table import Table

from test_strings import PATTERNS, VALUES, like_match

torch.set_num_threads(1)


def _table():
    return Table.from_pydict({"s": np.array(VALUES)})


def _mask(expr, t) -> np.ndarray:
    return evaluate(expr, t).data.numpy()


def _ref_mask(expr) -> np.ndarray:
    return np.asarray(jex.evaluate(
        expr, JTable.from_pydict({"s": np.array(VALUES)})).data)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_matches_independent_oracle(pattern):
    got = _mask(Like(Col("s"), pattern), _table())
    want = np.array([like_match(pattern, s) for s in VALUES])
    assert (got == want).all(), f"pattern {pattern!r}: {got} vs {want}"
    assert (got == _ref_mask(jex.Like(jex.Col("s"), pattern))).all()


@pytest.mark.parametrize("pattern", PATTERNS)
def test_like_negate(pattern):
    t = _table()
    pos = _mask(Like(Col("s"), pattern), t)
    neg = _mask(Like(Col("s"), pattern, negate=True), t)
    assert (pos ^ neg).all()


def test_like_fastpath_classification():
    assert strings.analyze_like("abc%") == ("prefix", "abc")
    assert strings.analyze_like("abc") == ("exact", "abc")
    assert strings.analyze_like("%") == ("prefix", "")
    assert strings.analyze_like("") == ("exact", "")
    assert strings.analyze_like("a\\%b") == ("exact", "a%b")
    assert strings.analyze_like("ab\\%") == ("exact", "ab%")
    assert strings.analyze_like("%a%b%")[0] == "general"
    assert strings.analyze_like("a_c")[0] == "general"
    assert strings.analyze_like("a%c")[0] == "general"


def test_empty_pattern_matches_only_empty_string():
    got = _mask(Like(Col("s"), ""), _table())
    assert got.sum() == 1 and got[VALUES.index("")]


def test_starts_with_matches_python():
    t = _table()
    for prefix in ["", "a", "ab", "goog", "https://", "z", "a%"]:
        got = _mask(StartsWith(Col("s"), prefix), t)
        want = np.array([s.startswith(prefix) for s in VALUES])
        assert (got == want).all(), prefix
        neg = _mask(StartsWith(Col("s"), prefix, negate=True), t)
        assert (got ^ neg).all()
        assert (got == _ref_mask(jex.StartsWith(jex.Col("s"), prefix))).all()


def test_prefix_range_handles_max_codepoint():
    vals = ["ab", "abc", "ab\U0010FFFF", "ab\U0010FFFFz", "ac", "b"]
    t = Table.from_pydict({"s": np.array(vals)})
    got = _mask(StartsWith(Col("s"), "ab"), t)
    want = np.array([s.startswith("ab") for s in vals])
    assert (got == want).all()
    assert (_mask(Like(Col("s"), "ab%"), t) == want).all()


def test_substr_matches_python_slicing():
    t = _table()
    for start, length in [(1, 2), (2, 3), (1, 100), (5, 1), (50, 2)]:
        col = evaluate(Substr(Col("s"), start, length), t)
        got = col.dictionary[col.data.numpy()]
        want = np.array([s[start - 1: start - 1 + length] for s in VALUES])
        assert (got == want).all(), (start, length)


def test_in_list_values_longer_than_dictionary_width():
    t = Table.from_pydict({"s": np.array(["apple", "pear"])})
    assert not _mask(InList(Col("s"), ["apple1"]), t).any()
    got = _mask(InList(Col("s"), ["apple1", "pear"]), t)
    assert (got == np.array([False, True])).all()


def test_in_list_mask_and_negate():
    t = _table()
    vals = ["a", "google", "nope"]
    got = _mask(InList(Col("s"), vals), t)
    want = np.array([s in vals for s in VALUES])
    assert (got == want).all()
    neg = _mask(InList(Col("s"), vals, negate=True), t)
    assert (got ^ neg).all()
    assert (got == _ref_mask(jex.InList(jex.Col("s"), vals))).all()


def test_substr_transform_identity_stable():
    t = _table()
    a = evaluate(Substr(Col("s"), 1, 2), t)
    b = evaluate(Substr(Col("s"), 1, 2), t)
    assert a.dictionary is b.dictionary
    c = evaluate(Substr(Col("s"), 1, 3), t)
    assert c.dictionary is not a.dictionary


def test_merged_dictionary_identity_stable():
    d1 = np.unique(np.array(["a", "b", "c"]))
    d2 = np.unique(np.array(["b", "d"]))
    m1 = strings.merged_dictionary(d1, d2)
    assert strings.merged_dictionary(d1, d2) is m1
    assert list(m1) == ["a", "b", "c", "d"]


def test_host_pass_runs_once_per_dictionary_and_pattern():
    t = _table()
    evaluate(Like(Col("s"), "%unique-probe-xyz%"), t)
    before = dict(strings.stats)
    for _ in range(5):
        evaluate(Like(Col("s"), "%unique-probe-xyz%"), t)
    after = dict(strings.stats)
    assert after["host_passes"] == before["host_passes"]
    assert after["cache_hits"] > before["cache_hits"]


def _stats_catalog(with_dicts: bool):
    from repro_torch.sql.binder import Catalog

    schema = {
        "fact": {"f_id": "numeric", "f_d1": "numeric", "f_d2": "numeric"},
        "dim1": {"d1_id": "numeric", "d1_name": "string"},
        "dim2": {"d2_id": "numeric", "d2_name": "string"},
    }
    rows = {"fact": 10_000.0, "dim1": 500.0, "dim2": 600.0}
    dicts = None
    if with_dicts:
        d1 = np.unique(np.array([f"x{i}" for i in range(100)]))
        d2 = np.unique(np.array(["zq0"] + [f"y{i}" for i in range(99)]))
        dicts = {"dim1": {"d1_name": d1}, "dim2": {"d2_name": d2}}
    return Catalog(schema, rows, dicts)


def test_selectivity_uses_dictionary_hit_rate():
    from repro_torch.optimizer.stats import SEL_LIKE, selectivity

    e = Like(Col("d1_name"), "%x%")
    assert selectivity(e, None) == SEL_LIKE
    assert selectivity(e, _stats_catalog(True)) == 1.0
    rare = Like(Col("d2_name"), "%zq%")
    assert selectivity(rare, _stats_catalog(True)) == pytest.approx(0.01)
    assert selectivity(rare, _stats_catalog(False)) == SEL_LIKE


def test_join_reorder_regression_with_dictionary_stats():
    from repro_torch.core.plan import JoinRel, ReadRel, walk
    from repro_torch.sql import sql_to_plan

    sql = ("select count(*) as c from fact, dim1, dim2 "
           "where f_d1 = d1_id and f_d2 = d2_id "
           "and d1_name like '%x%' and d2_name like '%zq%'")

    def first_build_table(catalog):
        plan = sql_to_plan(sql, catalog)
        joins = [r for r in walk(plan) if isinstance(r, JoinRel)]
        bottom = [j for j in joins if isinstance(j.probe, ReadRel)
                  and j.probe.table == "fact"]
        assert len(bottom) == 1
        build = bottom[0].build
        while not isinstance(build, ReadRel):
            build = build.inputs()[0]
        return build.table

    assert first_build_table(_stats_catalog(False)) == "dim1"
    assert first_build_table(_stats_catalog(True)) == "dim2"


def test_sql_starts_with_equivalent_to_prefix_like(tpch_db):
    from repro_torch.core.executor import SiriusEngine
    from repro_torch.data.tpch import load_into_engine

    eng = SiriusEngine(device="cpu")
    load_into_engine(eng, tpch_db)
    a = eng.sql("select count(*) as c from part "
                "where starts_with(p_name, 'gre')").to_host()
    b = eng.sql("select count(*) as c from part "
                "where p_name like 'gre%'").to_host()
    assert int(a["c"][0]) == int(b["c"][0]) > 0

"""COUNT(DISTINCT) on the port's kernel path, on the CPU: the plain version
of the ``count_distinct`` kernel against a numpy oracle, the wrapper's
sizing, and ``try_aggregate``'s route (group-bys with a count distinct, as
ClickBench's and TPC-H's queries ask for them, and q6's min/max alone)
against the generic ``group_aggregate``."""
import numpy as np
import pytest
import torch

from repro_torch.core import kernel_backend
from repro_torch.kernels import count_distinct as cd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import count_distinct_ref
from repro_torch.observability.metrics import METRICS
from repro_torch.relational.aggregate import AggSpec, group_aggregate
from repro_torch.relational.expressions import Col
from repro_torch.relational.table import Column, Table

torch.set_num_threads(1)

I64 = np.iinfo(np.int64)


def _oracle(gids: np.ndarray, values: np.ndarray, g: int) -> np.ndarray:
    keep = (gids >= 0) & (gids < g)
    out = np.zeros(g, np.int64)
    for k in range(g):
        out[k] = np.unique(values[keep & (gids == k)]).size
    return out


def _case(name: str):
    rng = np.random.default_rng(7)
    if name == "empty input":
        return np.zeros(0, np.int32), np.zeros(0, np.int64), 3
    if name == "one group":
        return (np.zeros(5_000, np.int32),
                rng.integers(0, 700, 5_000).astype(np.int64), 1)
    if name == "all rows one value":
        return (rng.integers(0, 4, 3_000).astype(np.int32),
                np.full(3_000, 123_456_789_012, np.int64), 4)
    if name == "int64 extremes":
        # the ends of the range, and -1 and -2: the bytes of the kernel's
        # empty and busy tags, read as values
        pool = np.array([I64.min, I64.max, -1, -2, 0, 1, I64.min + 1,
                         I64.max - 1], np.int64)
        return (rng.integers(0, 3, 4_000).astype(np.int32),
                rng.choice(pool, 4_000), 3)
    if name == "empty groups":
        return (rng.choice([0, 3, 7], 2_000).astype(np.int32),
                rng.integers(-50, 50, 2_000).astype(np.int64), 10)
    if name == "gids out of range dropped":
        return (rng.integers(-2, 6, 2_000).astype(np.int32),
                rng.integers(0, 40, 2_000).astype(np.int64), 4)
    if name == "63-bit ids, skewed, many groups":
        ids = rng.integers(0, 2**63 - 1, 900, dtype=np.int64)
        return (rng.integers(0, 300, 20_000).astype(np.int32),
                ids[np.minimum(rng.zipf(1.3, 20_000), 900) - 1], 300)
    raise KeyError(name)


CASES = ("empty input", "one group", "all rows one value", "int64 extremes",
         "empty groups", "gids out of range dropped",
         "63-bit ids, skewed, many groups")


@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_numpy_unique(name):
    gids, values, g = _case(name)
    got = count_distinct_ref(torch.from_numpy(gids), torch.from_numpy(values), g)
    assert got.dtype == torch.int64 and got.shape == (g,)
    np.testing.assert_array_equal(got.numpy(), _oracle(gids, values, g))


@pytest.mark.parametrize("name", CASES)
def test_wrapper_takes_the_plain_version_on_the_cpu(name):
    gids, values, g = _case(name)
    gi, va = torch.from_numpy(gids), torch.from_numpy(values)
    assert torch.equal(ops.count_distinct(gi, va, g),
                       count_distinct_ref(gi, va, g))


@pytest.mark.parametrize("n,slots", [(0, 2), (1, 2), (2, 4), (3, 8), (1000, 2048),
                                     (1024, 2048), (99_997_497, 2**28),
                                     (2**24, 2**25)])
def test_table_holds_at_least_twice_the_rows_in_a_power_of_two(n, slots):
    assert cd.table_slots(n) == slots
    assert slots >= 2 * n and slots & (slots - 1) == 0


@pytest.mark.parametrize("rows,sms,blocks", [(1, 132, 1), (256, 132, 1),
                                             (257, 132, 2),
                                             (99_997_497, 132, 8 * 132),
                                             (2**28, 132, 8 * 132)])
def test_grids_cover_their_items_up_to_eight_blocks_an_sm(rows, sms, blocks):
    assert cd.grid_blocks(rows, sms) == blocks


def test_distinct_counters_count_each_call_and_its_rows():
    hits = METRICS.counter("kernel.distinct_hits")
    rows = METRICS.counter("kernel.distinct_rows")
    h0, r0 = hits.value, rows.value
    ops.count_distinct(torch.zeros(10, dtype=torch.int32),
                       torch.arange(10), 1)
    ops.count_distinct(torch.zeros(0, dtype=torch.int32),
                       torch.zeros(0, dtype=torch.int64), 2)
    ops.count_distinct(torch.arange(7, dtype=torch.int32) % 3,
                       torch.ones(7, dtype=torch.int64), 3)
    assert hits.value - h0 == 3
    assert rows.value - r0 == 17


# ---------------------------------------------------------------------------
# the route: try_aggregate with count_distinct against group_aggregate
# ---------------------------------------------------------------------------


def _hits_table(n: int = 6_000, seed: int = 11) -> Table:
    """A small table with ``hits``' columns and kinds: 63-bit user ids
    (skewed), dictionary-coded phrases and phone models, small int ids."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 2**63 - 1, 400, dtype=np.int64)
    phrases = np.array(["", "a b", "bc", "google", "x y z", "zz"])
    models = np.array(["", "iPhone", "N8", "Galaxy"])
    return Table({
        "UserID": Column.from_numpy(
            users[np.minimum(rng.zipf(1.2, n), 400) - 1]),
        "SearchPhrase": Column.from_strings(list(rng.choice(phrases, n))),
        "RegionID": Column.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
        "MobilePhone": Column.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
        "MobilePhoneModel": Column.from_strings(list(rng.choice(models, n))),
        "AdvEngineID": Column.from_numpy(
            np.where(rng.random(n) < 0.9, 0, rng.integers(1, 20, n)).astype(np.int32)),
        "ResolutionWidth": Column.from_numpy(
            rng.choice([0, 1024, 1366, 1920], n).astype(np.int32)),
        "EventDate": Column.from_numpy(
            np.datetime64("2013-07-01")
            + rng.integers(0, 31, n).astype("timedelta64[D]")),
    })


def _tpch_table(n: int = 5_000, seed: int = 5) -> Table:
    """Q16's and Q21's group-bys: part attributes and ps_suppkey; l_orderkey
    (sparse) and l_suppkey."""
    rng = np.random.default_rng(seed)
    return Table({
        "p_brand": Column.from_strings(
            list(rng.choice([f"Brand#{i}{j}" for i in range(1, 6)
                             for j in range(1, 6)], n))),
        "p_type": Column.from_strings(
            list(rng.choice(["SMALL ANODIZED TIN", "LARGE BRUSHED COPPER",
                             "PROMO PLATED STEEL"], n))),
        "p_size": Column.from_numpy(rng.integers(1, 51, n).astype(np.int32)),
        "ps_suppkey": Column.from_numpy(rng.integers(1, 200, n)),
        "l_orderkey": Column.from_numpy(rng.integers(1, 6_000_000, n) // 37 * 32),
        "l_suppkey": Column.from_numpy(rng.integers(1, 100, n)),
    })


def _d(col, name):
    return AggSpec("count_distinct", Col(col), name)


ROUTES = {
    "q4": ([], [_d("UserID", "u")]),
    "q5": ([], [_d("SearchPhrase", "p")]),
    # min/max only, no count distinct: no groupby_sum for counts it drops
    "q6": ([], [AggSpec("min", Col("EventDate"), "lo"),
                AggSpec("max", Col("EventDate"), "hi")]),
    "q8": (["RegionID"], [_d("UserID", "u")]),
    "q9": (["RegionID"], [AggSpec("sum", Col("AdvEngineID"), "s"),
                          AggSpec("count_star", None, "c"),
                          AggSpec("avg", Col("ResolutionWidth"), "w"),
                          _d("UserID", "u")]),
    "q11": (["MobilePhone", "MobilePhoneModel"], [_d("UserID", "u")]),
    "q22": (["SearchPhrase"], [AggSpec("min", Col("MobilePhoneModel"), "t"),
                               AggSpec("count_star", None, "c"),
                               _d("UserID", "uu")]),
    "Q16": (["p_brand", "p_type", "p_size"], [_d("ps_suppkey", "supplier_cnt")]),
    "Q21": (["l_orderkey"], [_d("l_suppkey", "n_all")]),
}


@pytest.mark.parametrize("qid", sorted(ROUTES))
def test_try_aggregate_counts_distinct_as_the_generic_group_by(qid):
    keys, aggs = ROUTES[qid]
    t = _tpch_table() if qid.startswith("Q") else _hits_table()
    got = kernel_backend.KernelBackend().try_aggregate(t, keys, aggs)
    assert got is not None
    want = group_aggregate(t, keys, aggs)
    assert got.column_names == want.column_names
    distinct = {a.name for a in aggs if a.fn == "count_distinct"}
    for name in want.column_names:
        a, b = got[name].data, want[name].data
        if name in distinct:
            assert a.dtype == b.dtype == torch.int64, name
        if b.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
        else:
            # the kernel route sums an int32 column into int64
            assert torch.equal(a.to(torch.int64), b.to(torch.int64)), name


@pytest.mark.parametrize("qid", sorted(ROUTES))
def test_groupby_sum_runs_only_for_counts_sums_and_averages(qid, monkeypatch):
    keys, aggs = ROUTES[qid]
    t = _tpch_table() if qid.startswith("Q") else _hits_table()
    calls = []
    real = ops.groupby_sum_large

    def counted(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(kernel_backend.kops, "groupby_sum_large", counted)
    kernel_backend.KernelBackend().try_aggregate(t, keys, aggs)
    additive = any(a.fn in ("sum", "count", "count_star", "avg") for a in aggs)
    assert bool(calls) == additive


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_float_count_distinct_declines(dtype):
    t = Table({"k": Column(torch.tensor([0, 0, 1], dtype=torch.int32)),
               "x": Column(torch.tensor([0.0, -0.0, float("nan")], dtype=dtype))})
    backend = kernel_backend.KernelBackend()
    assert backend.try_aggregate(t, ["k"], [_d("x", "n")]) is None
    assert backend.agg_hits == 0

"""TPC-H data generator (schema-faithful, FK-consistent, spec-like distributions).

The generator is a copy of ``repro/data/tpch.py`` (numpy only), kept so
the port imports nothing of ``repro``: ``generate(sf, seed)`` gives arrays
identical to the reference's, which the tests check.

A vectorized numpy re-implementation of dbgen sufficient for all 22 queries:
correct schemas, consistent foreign keys (including the 4-suppliers-per-part
partsupp structure and the "only 2/3 of customers have orders" rule that Q13 /
Q22 depend on), spec word lists for p_name/p_type/p_brand/containers/modes,
date arithmetic relations (ship/commit/receipt), and comment streams that
contain the exact patterns probed by Q13/Q16.

Output is the **host database format**: dict[table] -> dict[col] -> np.ndarray
(strings as unicode arrays, dates as datetime64[D]).  The buffer manager
deep-copies this into the device cache (the paper's cold run).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

HostDB = Dict[str, Dict[str, np.ndarray]]

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
# 25 nations with their spec region keys
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"])
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"])
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"])
INSTRUCTS = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
TYPE_S1 = np.array(["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"])
TYPE_S2 = np.array(["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"])
TYPE_S3 = np.array(["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"])
CONT_S1 = np.array(["SM", "LG", "MED", "JUMBO", "WRAP"])
CONT_S2 = np.array(["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"])
# P_NAME word list (subset of the spec's 92 words; includes the query probes)
P_WORDS = np.array([
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hunter", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
])
COMMENT_WORDS = np.array([
    "carefully", "quickly", "furiously", "slyly", "blithely", "deposits",
    "accounts", "packages", "requests", "instructions", "foxes", "pinto",
    "beans", "theodolites", "dependencies", "platelets", "ideas", "special",
    "regular", "express", "bold", "final", "pending", "ironic", "even",
    "silent", "unusual", "Customer", "Complaints", "sleep", "haggle", "nag",
    "wake", "cajole", "detect", "integrate", "engage", "above", "against",
])

START = np.datetime64("1992-01-01", "D")
END = np.datetime64("1998-08-02", "D")
CURRENTDATE = np.datetime64("1995-06-17", "D")

# ---------------------------------------------------------------------------
# Catalog metadata: the schema the SQL binder resolves against and the base
# cardinalities (rows at SF1) the optimizer's cost heuristics start from.
# Kinds mirror relational.table: numeric | string | date.
# ---------------------------------------------------------------------------

TPCH_SCHEMA = {
    "region": {
        "r_regionkey": "numeric", "r_name": "string", "r_comment": "string",
    },
    "nation": {
        "n_nationkey": "numeric", "n_name": "string",
        "n_regionkey": "numeric", "n_comment": "string",
    },
    "supplier": {
        "s_suppkey": "numeric", "s_name": "string", "s_address": "string",
        "s_nationkey": "numeric", "s_phone": "string", "s_acctbal": "numeric",
        "s_comment": "string",
    },
    "part": {
        "p_partkey": "numeric", "p_name": "string", "p_mfgr": "string",
        "p_brand": "string", "p_type": "string", "p_size": "numeric",
        "p_container": "string", "p_retailprice": "numeric",
        "p_comment": "string",
    },
    "partsupp": {
        "ps_partkey": "numeric", "ps_suppkey": "numeric",
        "ps_availqty": "numeric", "ps_supplycost": "numeric",
        "ps_comment": "string",
    },
    "customer": {
        "c_custkey": "numeric", "c_name": "string", "c_address": "string",
        "c_nationkey": "numeric", "c_phone": "string", "c_acctbal": "numeric",
        "c_mktsegment": "string", "c_comment": "string",
    },
    "orders": {
        "o_orderkey": "numeric", "o_custkey": "numeric",
        "o_orderstatus": "string", "o_totalprice": "numeric",
        "o_orderdate": "date", "o_orderpriority": "string",
        "o_clerk": "string", "o_shippriority": "numeric",
        "o_comment": "string",
    },
    "lineitem": {
        "l_orderkey": "numeric", "l_partkey": "numeric",
        "l_suppkey": "numeric", "l_linenumber": "numeric",
        "l_quantity": "numeric", "l_extendedprice": "numeric",
        "l_discount": "numeric", "l_tax": "numeric",
        "l_returnflag": "string", "l_linestatus": "string",
        "l_shipdate": "date", "l_commitdate": "date",
        "l_receiptdate": "date", "l_shipinstruct": "string",
        "l_shipmode": "string", "l_comment": "string",
    },
}

TPCH_BASE_ROWS = {
    "region": 5, "nation": 25, "supplier": 10_000, "part": 200_000,
    "partsupp": 800_000, "customer": 150_000, "orders": 1_500_000,
    "lineitem": 6_000_000,
}


def _comments(rng: np.random.Generator, n: int, words: int = 4) -> np.ndarray:
    idx = rng.integers(0, len(COMMENT_WORDS), size=(n, words))
    parts = COMMENT_WORDS[idx]
    out = parts[:, 0]
    for j in range(1, words):
        out = np.char.add(np.char.add(out, " "), parts[:, j])
    return out


def _phones(rng: np.random.Generator, nkeys: np.ndarray) -> np.ndarray:
    cc = np.char.zfill((nkeys + 10).astype(str), 2)
    def seg(lo, hi, width):
        return np.char.zfill(rng.integers(lo, hi, size=len(nkeys)).astype(str), width)
    return np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        np.char.add(cc, "-"), seg(100, 999, 3)), "-"), seg(100, 999, 3)), "-"),
        seg(1000, 9999, 4))


def generate(scale_factor: float = 0.01, seed: int = 19920101) -> HostDB:
    rng = np.random.default_rng(seed)
    sf = scale_factor
    n_supp = max(int(10_000 * sf), 20)
    n_part = max(int(200_000 * sf), 50)
    n_cust = max(int(150_000 * sf), 30)
    n_ord = max(int(1_500_000 * sf), 150)

    db: HostDB = {}

    # region / nation --------------------------------------------------------
    db["region"] = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS.copy(),
        "r_comment": _comments(rng, 5),
    }
    n_names = np.array([n for n, _ in NATIONS])
    n_rk = np.array([r for _, r in NATIONS], dtype=np.int64)
    db["nation"] = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": n_names,
        "n_regionkey": n_rk,
        "n_comment": _comments(rng, 25),
    }

    # supplier ----------------------------------------------------------------
    sk = np.arange(1, n_supp + 1, dtype=np.int64)
    s_nk = rng.integers(0, 25, n_supp)
    # 5 per 10k suppliers get the Customer Complaints comment (spec-like rarity,
    # scaled so small SFs still exercise Q16's anti join)
    s_comment = _comments(rng, n_supp)
    n_complaints = max(n_supp // 200, 2)
    idx = rng.choice(n_supp, n_complaints, replace=False)
    s_comment[idx] = np.char.add(
        np.char.add("take Customer ", _comments(rng, n_complaints, 1)),
        " Complaints against")
    db["supplier"] = {
        "s_suppkey": sk,
        "s_name": np.char.add("Supplier#", np.char.zfill(sk.astype(str), 9)),
        "s_address": _comments(rng, n_supp, 2),
        "s_nationkey": s_nk,
        "s_phone": _phones(rng, s_nk),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": s_comment,
    }

    # part ---------------------------------------------------------------------
    pk = np.arange(1, n_part + 1, dtype=np.int64)
    w = P_WORDS[rng.integers(0, len(P_WORDS), size=(n_part, 5))]
    p_name = w[:, 0]
    for j in range(1, 5):
        p_name = np.char.add(np.char.add(p_name, " "), w[:, j])
    m = rng.integers(1, 6, n_part)
    nn = rng.integers(1, 6, n_part)
    p_type = np.char.add(np.char.add(np.char.add(
        TYPE_S1[rng.integers(0, 6, n_part)], " "),
        np.char.add(TYPE_S2[rng.integers(0, 5, n_part)], " ")),
        TYPE_S3[rng.integers(0, 5, n_part)])
    db["part"] = {
        "p_partkey": pk,
        "p_name": p_name,
        "p_mfgr": np.char.add("Manufacturer#", m.astype(str)),
        "p_brand": np.char.add(np.char.add("Brand#", m.astype(str)), nn.astype(str)),
        "p_type": p_type,
        "p_size": rng.integers(1, 51, n_part),
        "p_container": np.char.add(np.char.add(
            CONT_S1[rng.integers(0, 5, n_part)], " "),
            CONT_S2[rng.integers(0, 8, n_part)]),
        "p_retailprice": np.round(
            (90000 + (pk % 20001) / 10 + 100 * (pk % 1000)) / 100, 2),
        "p_comment": _comments(rng, n_part, 2),
    }

    # partsupp: exactly 4 distinct suppliers per part (spec formula) -----------
    i = np.repeat(np.arange(4), n_part)
    ps_pk = np.tile(pk, 4)
    ps_sk = ((ps_pk - 1 + i * (n_supp // 4 + (ps_pk - 1) // n_supp)) % n_supp) + 1
    order_ps = np.lexsort((ps_sk, ps_pk))
    ps_pk, ps_sk = ps_pk[order_ps], ps_sk[order_ps]
    n_ps = len(ps_pk)
    db["partsupp"] = {
        "ps_partkey": ps_pk,
        "ps_suppkey": ps_sk.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
        "ps_comment": _comments(rng, n_ps, 3),
    }

    # customer -----------------------------------------------------------------
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nk = rng.integers(0, 25, n_cust)
    db["customer"] = {
        "c_custkey": ck,
        "c_name": np.char.add("Customer#", np.char.zfill(ck.astype(str), 9)),
        "c_address": _comments(rng, n_cust, 2),
        "c_nationkey": c_nk,
        "c_phone": _phones(rng, c_nk),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": SEGMENTS[rng.integers(0, 5, n_cust)],
        "c_comment": _comments(rng, n_cust, 3),
    }

    # orders: only customers with custkey % 3 != 0 place orders (spec) ----------
    ok = np.arange(1, n_ord + 1, dtype=np.int64)
    eligible = ck[ck % 3 != 0]
    o_ck = rng.choice(eligible, n_ord)
    span = int((END - START).astype(int)) - 151
    o_date = START + rng.integers(0, span, n_ord).astype("timedelta64[D]")
    o_comment = _comments(rng, n_ord, 3)
    # inject '%special%requests%' pattern probed by Q13 (~1% of orders)
    n_special = max(n_ord // 100, 3)
    idx = rng.choice(n_ord, n_special, replace=False)
    o_comment[idx] = np.char.add(
        np.char.add("handle special ", _comments(rng, n_special, 1)),
        " requests carefully")

    # lineitem: 1..7 lines per order --------------------------------------------
    lines_per = rng.integers(1, 8, n_ord)
    n_li = int(lines_per.sum())
    l_ok = np.repeat(ok, lines_per)
    starts = np.zeros(n_ord, np.int64)
    np.cumsum(lines_per[:-1], out=starts[1:])
    l_ln = (np.arange(n_li) - np.repeat(starts, lines_per) + 1).astype(np.int64)
    l_pk = rng.integers(1, n_part + 1, n_li).astype(np.int64)
    which = rng.integers(0, 4, n_li)
    l_sk = ((l_pk - 1 + which * (n_supp // 4 + (l_pk - 1) // n_supp)) % n_supp) + 1
    qty = rng.integers(1, 51, n_li).astype(np.int64)
    retail = db["part"]["p_retailprice"][l_pk - 1]
    ext = np.round(qty * retail, 2)
    disc = np.round(rng.integers(0, 11, n_li) / 100.0, 2)
    tax = np.round(rng.integers(0, 9, n_li) / 100.0, 2)
    o_date_per_line = np.repeat(o_date, lines_per)
    shipd = o_date_per_line + rng.integers(1, 122, n_li).astype("timedelta64[D]")
    commitd = o_date_per_line + rng.integers(30, 91, n_li).astype("timedelta64[D]")
    receiptd = shipd + rng.integers(1, 31, n_li).astype("timedelta64[D]")
    returnflag = np.where(
        receiptd <= CURRENTDATE,
        np.where(rng.random(n_li) < 0.5, "R", "A"), "N").astype("U1")
    linestatus = np.where(shipd > CURRENTDATE, "O", "F").astype("U1")

    net = ext * (1 - disc) * (1 + tax)
    totalprice = np.zeros(n_ord)
    np.add.at(totalprice, np.repeat(np.arange(n_ord), lines_per), net)

    db["orders"] = {
        "o_orderkey": ok,
        "o_custkey": o_ck,
        "o_orderstatus": np.where(
            np.bincount(np.repeat(np.arange(n_ord), lines_per),
                        (linestatus == "F"), n_ord) == lines_per, "F",
            np.where(np.bincount(np.repeat(np.arange(n_ord), lines_per),
                                 (linestatus == "O"), n_ord) == lines_per,
                     "O", "P")).astype("U1"),
        "o_totalprice": np.round(totalprice, 2),
        "o_orderdate": o_date,
        "o_orderpriority": PRIORITIES[rng.integers(0, 5, n_ord)],
        "o_clerk": np.char.add("Clerk#", np.char.zfill(
            rng.integers(1, max(int(1000 * sf), 10) + 1, n_ord).astype(str), 9)),
        "o_shippriority": np.zeros(n_ord, np.int64),
        "o_comment": o_comment,
    }
    db["lineitem"] = {
        "l_orderkey": l_ok,
        "l_partkey": l_pk,
        "l_suppkey": l_sk.astype(np.int64),
        "l_linenumber": l_ln,
        "l_quantity": qty.astype(np.float64),
        "l_extendedprice": ext,
        "l_discount": disc,
        "l_tax": tax,
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipd,
        "l_commitdate": commitd,
        "l_receiptdate": receiptd,
        "l_shipinstruct": INSTRUCTS[rng.integers(0, 4, n_li)],
        "l_shipmode": SHIPMODES[rng.integers(0, 7, n_li)],
        "l_comment": _comments(rng, n_li, 2),
    }
    return db


def load_into_engine(engine, db: HostDB) -> None:
    """Cold-run load: host format → device cache via the buffer manager."""
    from ..relational.table import Table

    for name, cols in db.items():
        engine.register(name, Table.from_pydict(cols))

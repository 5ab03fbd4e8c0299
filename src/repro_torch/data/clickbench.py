"""ClickBench workload: hits-table sample generator + query set —
counterpart of ``repro/data/clickbench.py``, giving identical arrays.

The paper's headline is dual-benchmark — 8.3x cost efficiency on TPC-H and
**7.4x on ClickBench** — so the repro carries both.  ClickBench is a single
denormalized web-analytics table (``hits``, ~100M rows in the official
dataset) probed by scan-heavy queries: top-K group-bys, substring/LIKE URL
filters, and distinct-user counts.  That makes it the acceptance workload
for the device-resident string subsystem: most queries touch a
dictionary-encoded string column in the hot path.

This module generates a **schema-faithful sample**: a representative subset
of the official column list (names and types as in the ClickBench DDL,
lowercased because the SQL frontend lowercases identifiers) with
web-analytics-shaped distributions — zipfian URL/phrase/region popularity,
mostly-empty ``searchphrase``/``mobilephonemodel``, sparse 64-bit user ids,
a two-week event window.  Absolute numbers are synthetic; the *shapes* that
drive the engine (dictionary sizes ≪ row counts, heavy-hitter skew, empty-
string majorities) are faithful.

``CLICKBENCH_QUERIES`` holds SQL text for a representative selection of the
official 43 queries (official numbering; a few marked ``x``-suffixed are
repro additions exercising ``starts_with``/``substring``).  Deviation from
the official text, determinism-preserving: every ORDER BY gets explicit
tie-breaking keys so engine and oracle agree row-for-row.

Output is the host database format: dict[table] -> dict[col] -> np.ndarray.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

HostDB = Dict[str, Dict[str, np.ndarray]]

# official dataset cardinality (for optimizer cost estimates at full scale)
CLICKBENCH_BASE_ROWS = {"hits": 99_997_497}

# Column subset of the official hits DDL (lowercased).  Kinds mirror
# relational.table: numeric | string | date.  eventtime is epoch seconds
# (the engine has no timestamp kind; ClickHouse stores it as one anyway).
CLICKBENCH_SCHEMA = {
    "hits": {
        "watchid": "numeric", "javaenable": "numeric", "title": "string",
        "goodevent": "numeric", "eventtime": "numeric", "eventdate": "date",
        "counterid": "numeric", "clientip": "numeric", "regionid": "numeric",
        "userid": "numeric", "os": "numeric", "useragent": "numeric",
        "url": "string", "referer": "string", "isrefresh": "numeric",
        "resolutionwidth": "numeric", "resolutionheight": "numeric",
        "mobilephone": "numeric", "mobilephonemodel": "string",
        "searchphrase": "string", "searchengineid": "numeric",
        "advengineid": "numeric", "traficsourceid": "numeric",
        "dontcounthits": "numeric",
    },
}

_HOSTS = np.array([
    "yandex.ru", "google.com", "images.google.com", "translate.google.com",
    "mail.google.com", "news.google.com", "auto.ru", "avito.ru", "vk.com",
    "facebook.com", "wikipedia.org", "news.mail.ru", "rambler.ru",
    "smeshariki.ru", "korablitz.ru", "rutube.ru", "kinopoisk.ru",
    "livejournal.com", "odnoklassniki.ru", "booking.com",
])
_PATHS = np.array([
    "search", "news", "cars", "video", "images", "maps", "market", "forum",
    "blog", "chat", "weather", "sport", "music", "films", "games",
])
_BRANDS = np.array([
    "Google", "Yandex", "Bing", "Mail.Ru", "Avito", "Auto.ru", "Wikipedia",
    "RuTube", "Kinopoisk", "VK",
])
_WORDS = np.array([
    "cars", "weather", "news", "photo", "video", "hotel", "flights", "games",
    "music", "films", "phone", "notebook", "recipe", "holiday", "tickets",
    "football", "exchange", "rates", "series", "torrent", "review", "forum",
    "download", "online", "free", "cheap", "new", "best", "top", "sale",
])
_MODELS = np.array([
    "iPhone", "iPad", "Nokia Lumia", "Samsung Galaxy", "HTC One",
    "Sony Xperia", "LG Optimus", "Nexus",
])

_EPOCH = np.datetime64("1970-01-01", "D")
_WINDOW_START = np.datetime64("2013-07-01", "D")   # the official window
_WINDOW_DAYS = 15


def _zipf_weights(n: int, s: float = 1.1) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def _pool_pick(rng, pool: np.ndarray, n: int, s: float = 1.1) -> np.ndarray:
    return pool[rng.choice(len(pool), n, p=_zipf_weights(len(pool), s))]


def generate(n_rows: int = 100_000, seed: int = 20130701) -> HostDB:
    """Generate a hits-table sample (host database format)."""
    rng = np.random.default_rng(seed)
    n = int(n_rows)

    # -- URL pool: scheme://host/path?id=k, zipf-popular -------------------
    n_urls = min(5000, max(200, n // 20))
    k = np.arange(n_urls)
    hosts = _HOSTS[rng.integers(0, len(_HOSTS), n_urls)]
    paths = _PATHS[rng.integers(0, len(_PATHS), n_urls)]
    schemes = np.where(rng.random(n_urls) < 0.3, "https", "http")
    url_pool = np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        np.char.add(schemes, "://"), hosts), "/"), paths), "?id="),
        k.astype(str))
    url = _pool_pick(rng, url_pool, n)

    # referer: 40% empty, else another zipf pick from the same pool
    referer = np.where(rng.random(n) < 0.4, "", _pool_pick(rng, url_pool, n))

    # -- titles: "<word> <word> — <brand>" ---------------------------------
    n_titles = min(1500, max(100, n // 50))
    t1 = _WORDS[rng.integers(0, len(_WORDS), n_titles)]
    t2 = _WORDS[rng.integers(0, len(_WORDS), n_titles)]
    tb = _BRANDS[rng.integers(0, len(_BRANDS), n_titles)]
    title_pool = np.char.add(np.char.add(np.char.add(
        np.char.add(t1, " "), t2), " - "), tb)
    title = _pool_pick(rng, title_pool, n)

    # -- search phrases: 70% empty, zipf over two-word combos --------------
    n_phrases = min(600, max(50, n // 100))
    p1 = _WORDS[rng.integers(0, len(_WORDS), n_phrases)]
    p2 = _WORDS[rng.integers(0, len(_WORDS), n_phrases)]
    phrase_pool = np.char.add(np.char.add(p1, " "), p2)
    searchphrase = np.where(rng.random(n) < 0.7, "",
                            _pool_pick(rng, phrase_pool, n))
    has_phrase = searchphrase != ""
    searchengineid = np.where(
        has_phrase, rng.choice([2, 3, 58, 70], n, p=[0.6, 0.25, 0.1, 0.05]),
        0).astype(np.int64)

    # -- mobile: 90% desktop (empty model) ---------------------------------
    mobilephonemodel = np.where(rng.random(n) < 0.9, "",
                                _pool_pick(rng, _MODELS, n, 1.0))
    mobilephone = np.where(mobilephonemodel == "", 0,
                           rng.integers(1, 90, n)).astype(np.int64)

    # -- users/regions/counters: heavy-hitter skew -------------------------
    n_users = max(100, n // 3)
    user_pool = rng.integers(1 << 40, 1 << 44, n_users, dtype=np.int64)
    userid = _pool_pick(rng, user_pool, n, 1.2)
    regionid = rng.choice(np.arange(1, 230, dtype=np.int64), n,
                          p=_zipf_weights(229, 1.3))
    counterid = rng.choice(np.arange(1, 120, dtype=np.int64), n,
                           p=_zipf_weights(119, 1.1))

    # -- time window -------------------------------------------------------
    day = rng.integers(0, _WINDOW_DAYS, n)
    eventdate = _WINDOW_START + day.astype("timedelta64[D]")
    day_start = (_WINDOW_START - _EPOCH).astype(np.int64) * 86400
    eventtime = (day_start + day * 86400
                 + rng.integers(0, 86400, n)).astype(np.int64)

    widths = np.array([0, 1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560],
                      dtype=np.int64)
    resolutionwidth = rng.choice(
        widths, n, p=[0.08, 0.1, 0.18, 0.22, 0.1, 0.08, 0.1, 0.12, 0.02])
    resolutionheight = np.where(
        resolutionwidth == 0, 0, (resolutionwidth * 9) // 16).astype(np.int64)

    hits = {
        "watchid": rng.integers(1 << 40, 1 << 52, n, dtype=np.int64),
        "javaenable": (rng.random(n) < 0.85).astype(np.int64),
        "title": title,
        "goodevent": np.ones(n, np.int64),
        "eventtime": eventtime,
        "eventdate": eventdate,
        "counterid": counterid,
        "clientip": rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64),
        "regionid": regionid,
        "userid": userid,
        "os": rng.integers(0, 45, n, dtype=np.int64),
        "useragent": rng.integers(0, 83, n, dtype=np.int64),
        "url": url,
        "referer": referer,
        "isrefresh": (rng.random(n) < 0.07).astype(np.int64),
        "resolutionwidth": resolutionwidth,
        "resolutionheight": resolutionheight,
        "mobilephone": mobilephone,
        "mobilephonemodel": mobilephonemodel,
        "searchphrase": searchphrase,
        "searchengineid": searchengineid,
        "advengineid": np.where(rng.random(n) < 0.97, 0,
                                rng.integers(1, 20, n)).astype(np.int64),
        "traficsourceid": rng.integers(-1, 10, n, dtype=np.int64),
        "dontcounthits": (rng.random(n) < 0.05).astype(np.int64),
    }
    return {"hits": hits}


def clickbench_catalog(sample_rows: int = None):
    """Catalog for the hits schema (optimizer stats + binder resolution)."""
    from ..sql.binder import Catalog
    rows = {"hits": float(sample_rows if sample_rows is not None
                          else CLICKBENCH_BASE_ROWS["hits"])}
    return Catalog(CLICKBENCH_SCHEMA, rows)


def load_into_engine(engine, db: HostDB) -> None:
    """Cold-run load: host format → device cache via the buffer manager;
    the host dicts stay with the engine for host fragments."""
    from ..relational.table import Table

    for name, cols in db.items():
        engine.register(name, Table.from_pydict(cols), cols)


# ---------------------------------------------------------------------------
# the query set (official ClickBench numbering; *x = repro addition).
# Textual deviation from the official suite: explicit ORDER BY tie-breakers
# appended wherever the official text admits ties, so the accelerator
# engine and the numpy oracle agree row-for-row.
# ---------------------------------------------------------------------------

CLICKBENCH_QUERIES = {
    "q0": "select count(*) as c from hits",
    "q1": "select count(*) as c from hits where AdvEngineID <> 0",
    "q2": """
select sum(AdvEngineID) as s, count(*) as c,
       avg(ResolutionWidth) as w
from hits
""",
    "q4": "select count(distinct UserID) as u from hits",
    "q5": "select count(distinct SearchPhrase) as p from hits",
    "q6": "select min(EventDate) as lo, max(EventDate) as hi from hits",
    "q8": """
select RegionID, count(distinct UserID) as u
from hits
group by RegionID
order by u desc, RegionID
limit 10
""",
    "q10": """
select MobilePhoneModel, count(distinct UserID) as u
from hits
where MobilePhoneModel <> ''
group by MobilePhoneModel
order by u desc, MobilePhoneModel
limit 10
""",
    "q12": """
select SearchPhrase, count(*) as c
from hits
where SearchPhrase <> ''
group by SearchPhrase
order by c desc, SearchPhrase
limit 10
""",
    "q14": """
select SearchEngineID, SearchPhrase, count(*) as c
from hits
where SearchPhrase <> ''
group by SearchEngineID, SearchPhrase
order by c desc, SearchEngineID, SearchPhrase
limit 10
""",
    "q20": "select count(*) as c from hits where URL like '%google%'",
    "q21": """
select SearchPhrase, min(URL) as u, count(*) as c
from hits
where URL like '%google%' and SearchPhrase <> ''
group by SearchPhrase
order by c desc, SearchPhrase
limit 10
""",
    "q22": """
select SearchPhrase, min(URL) as u, min(Title) as t, count(*) as c,
       count(distinct UserID) as uu
from hits
where Title like '%Google%'
  and URL not like '%.google.%'
  and SearchPhrase <> ''
group by SearchPhrase
order by c desc, SearchPhrase
limit 10
""",
    # repro additions: the two string operations ClickBench itself buries
    # inside expressions — prefix predicates and substring group keys
    "q43x": "select count(*) as c from hits "
            "where starts_with(URL, 'https://')",
    "q44x": """
select substring(URL, 1, 12) as prefix, count(*) as c
from hits
group by prefix
order by c desc, prefix
limit 10
""",
}

# queries whose hot path evaluates a string predicate / transform — the
# device-residency acceptance set for the string subsystem
CLICKBENCH_STRING_QIDS = ("q10", "q12", "q14", "q20", "q21", "q22", "q43x",
                          "q44x")

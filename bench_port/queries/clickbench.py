"""28 of ClickBench's 43 official queries over ``hits``, frozen: q0–q17,
q19–q22 and q30–q35 of ``queries.sql`` (github.com/ClickHouse/ClickBench,
official numbering from 0).

Departures from the official texts, none of which changes an answer
that has one:

- every aggregate has an alias, as the port's own ClickBench texts have
  (``repro_torch/data/clickbench.py::CLICKBENCH_QUERIES``); the 13
  queries shared with that set keep its texts;
- every ORDER BY ends in tie-breaking keys (the group keys), so one answer
  is right row for row;
- q17's ``LIMIT 10`` without an ORDER BY has no single answer: it is
  ordered by its group keys.

The queries take no parameters: ``parameters`` is empty at every scale.
q18 (``extract(minute FROM EventTime)``) and q23–q29 and q36–q42 read
columns this configuration does not hold resident (``EventTime``,
``Referer``, ``CounterID``, ...) or functions the engine lacks (regexp,
``length``); ``configs/clickbench-hits.json`` lists them under
``assumed``.
"""
from __future__ import annotations

import re

# the literal of q19: a UserID the generator puts on a few rows
Q19_USERID = 435090932899640449

TEMPLATES = {
    "q0": "select count(*) as c from hits",
    "q1": "select count(*) as c from hits where AdvEngineID <> 0",
    "q2": """
select sum(AdvEngineID) as s, count(*) as c,
       avg(ResolutionWidth) as w
from hits
""",
    "q3": "select avg(UserID) as u from hits",
    "q4": "select count(distinct UserID) as u from hits",
    "q5": "select count(distinct SearchPhrase) as p from hits",
    "q6": "select min(EventDate) as lo, max(EventDate) as hi from hits",
    "q7": """
select AdvEngineID, count(*) as c
from hits
where AdvEngineID <> 0
group by AdvEngineID
order by c desc, AdvEngineID
""",
    "q8": """
select RegionID, count(distinct UserID) as u
from hits
group by RegionID
order by u desc, RegionID
limit 10
""",
    "q9": """
select RegionID, sum(AdvEngineID) as s, count(*) as c,
       avg(ResolutionWidth) as w, count(distinct UserID) as u
from hits
group by RegionID
order by c desc, RegionID
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
    "q11": """
select MobilePhone, MobilePhoneModel, count(distinct UserID) as u
from hits
where MobilePhoneModel <> ''
group by MobilePhone, MobilePhoneModel
order by u desc, MobilePhone, MobilePhoneModel
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
    "q13": """
select SearchPhrase, count(distinct UserID) as u
from hits
where SearchPhrase <> ''
group by SearchPhrase
order by u desc, SearchPhrase
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
    "q15": """
select UserID, count(*) as c
from hits
group by UserID
order by c desc, UserID
limit 10
""",
    "q16": """
select UserID, SearchPhrase, count(*) as c
from hits
group by UserID, SearchPhrase
order by c desc, UserID, SearchPhrase
limit 10
""",
    "q17": """
select UserID, SearchPhrase, count(*) as c
from hits
group by UserID, SearchPhrase
order by UserID, SearchPhrase
limit 10
""",
    "q19": f"select UserID from hits where UserID = {Q19_USERID}",
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
    "q30": """
select SearchEngineID, ClientIP, count(*) as c, sum(IsRefresh) as r,
       avg(ResolutionWidth) as w
from hits
where SearchPhrase <> ''
group by SearchEngineID, ClientIP
order by c desc, SearchEngineID, ClientIP
limit 10
""",
    "q31": """
select WatchID, ClientIP, count(*) as c, sum(IsRefresh) as r,
       avg(ResolutionWidth) as w
from hits
where SearchPhrase <> ''
group by WatchID, ClientIP
order by c desc, WatchID, ClientIP
limit 10
""",
    "q32": """
select WatchID, ClientIP, count(*) as c, sum(IsRefresh) as r,
       avg(ResolutionWidth) as w
from hits
group by WatchID, ClientIP
order by c desc, WatchID, ClientIP
limit 10
""",
    "q33": """
select URL, count(*) as c
from hits
group by URL
order by c desc, URL
limit 10
""",
    "q34": """
select 1 as one, URL, count(*) as c
from hits
group by 1, URL
order by c desc, URL
limit 10
""",
    "q35": """
select ClientIP, ClientIP - 1 as ip1, ClientIP - 2 as ip2,
       ClientIP - 3 as ip3, count(*) as c
from hits
group by ClientIP, ClientIP - 1, ClientIP - 2, ClientIP - 3
order by c desc, ClientIP
limit 10
""",
}

IDS = tuple(TEMPLATES)

# the resident columns (lowercase, as the engine names them)
SCHEMA = {
    "hits": ["watchid", "clientip", "userid", "regionid", "advengineid",
             "resolutionwidth", "mobilephone", "searchengineid", "isrefresh",
             "eventdate", "url", "title", "searchphrase", "mobilephonemodel"],
}


def parameters(qid: str, scale: float) -> dict:
    """No query takes a parameter."""
    return {}


def slots(qid: str, params: dict) -> dict:
    return {}


def text(qid: str, params: dict) -> str:
    return TEMPLATES[qid]


def columns(qid: str) -> list:
    """(table, column) pairs the text references, once each."""
    words = set(re.findall(r"[a-z_]+", TEMPLATES[qid].lower()))
    return [(t, c) for t, cols in SCHEMA.items() for c in cols if c in words]

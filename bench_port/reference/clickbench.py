"""The 28 ClickBench queries of ``queries/clickbench.py`` in plain
PyTorch, one function each, over the generated ``hits`` columns.

Each returns the result as host columns named and ordered as the query's
select list and ORDER BY.  Averages are computed in ``float_dtype``
(float64, or float32 for the control); sums and counts of integers are
exact integers, as SQL has them.
"""
from __future__ import annotations

import torch

from ..queries.clickbench import Q19_USERID
from .ops import Ref, Result, count_distinct, first, group, seg_count, seg_sum

T = "hits"


def _c(r: Ref, name: str, m=None) -> torch.Tensor:
    x = r.col(T, name)
    return x if m is None else x[m]


def _str(out: Result, r: Ref, name: str, codes: torch.Tensor) -> Result:
    return out.string(name, codes, r.dictionary(T, name))


def _nonempty(r: Ref, name: str) -> torch.Tensor:
    return _c(r, name) != r.code(T, name, "")


def _avg(r: Ref, v: torch.Tensor, gid, n: int, count) -> torch.Tensor:
    return seg_sum(v.to(r.f), gid, n) / count.to(r.f)


def _seg_min(v: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, gid, v, "amin", include_self=False)


def _one(r: Ref, v) -> torch.Tensor:
    return torch.as_tensor(v, device=r.device).reshape(1)


def q0(r):
    return Result().num("c", _one(r, r.ds.rows(T))).host()


def q1(r):
    return Result().num("c", _one(r, (_c(r, "advengineid") != 0).sum())).host()


def q2(r):
    w = _c(r, "resolutionwidth").to(r.f)
    return (Result()
            .num("s", _one(r, _c(r, "advengineid").sum()))
            .num("c", _one(r, r.ds.rows(T)))
            .num("w", _one(r, w.sum() / r.ds.rows(T))).host())


def q3(r):
    u = _c(r, "userid").to(r.f)
    return Result().num("u", _one(r, u.sum() / r.ds.rows(T))).host()


def q4(r):
    return Result().num("u", _one(r, torch.unique(_c(r, "userid")).numel())).host()


def q5(r):
    return Result().num("p", _one(r, torch.unique(_c(r, "searchphrase")).numel())).host()


def q6(r):
    d = _c(r, "eventdate")
    return Result().date("lo", d.min().reshape(1)).date("hi", d.max().reshape(1)).host()


def q7(r):
    m = _c(r, "advengineid") != 0
    adv = _c(r, "advengineid", m)
    gid, n = group([adv])
    out = Result().num("advengineid", first(adv, gid, n)).num("c", seg_count(gid, n))
    return out.host([("c", True), ("advengineid", False)])


def q8(r):
    reg = _c(r, "regionid")
    gid, n = group([reg])
    out = (Result().num("regionid", first(reg, gid, n))
           .num("u", count_distinct(gid, _c(r, "userid"), n)))
    return out.host([("u", True), ("regionid", False)], 10)


def q9(r):
    reg = _c(r, "regionid")
    gid, n = group([reg])
    cnt = seg_count(gid, n)
    out = (Result().num("regionid", first(reg, gid, n))
           .num("s", seg_sum(_c(r, "advengineid"), gid, n))
           .num("c", cnt)
           .num("w", _avg(r, _c(r, "resolutionwidth"), gid, n, cnt))
           .num("u", count_distinct(gid, _c(r, "userid"), n)))
    return out.host([("c", True), ("regionid", False)], 10)


def q10(r):
    m = _nonempty(r, "mobilephonemodel")
    model = _c(r, "mobilephonemodel", m)
    gid, n = group([model])
    out = _str(Result(), r, "mobilephonemodel", first(model, gid, n))
    out.num("u", count_distinct(gid, _c(r, "userid", m), n))
    return out.host([("u", True), ("mobilephonemodel", False)], 10)


def q11(r):
    m = _nonempty(r, "mobilephonemodel")
    phone, model = _c(r, "mobilephone", m), _c(r, "mobilephonemodel", m)
    gid, n = group([phone, model])
    out = Result().num("mobilephone", first(phone, gid, n))
    _str(out, r, "mobilephonemodel", first(model, gid, n))
    out.num("u", count_distinct(gid, _c(r, "userid", m), n))
    return out.host([("u", True), ("mobilephone", False),
                     ("mobilephonemodel", False)], 10)


def _by_phrase(r, m):
    phrase = _c(r, "searchphrase", m)
    gid, n = group([phrase])
    return phrase, gid, n, _str(Result(), r, "searchphrase", first(phrase, gid, n))


def q12(r):
    _, gid, n, out = _by_phrase(r, _nonempty(r, "searchphrase"))
    out.num("c", seg_count(gid, n))
    return out.host([("c", True), ("searchphrase", False)], 10)


def q13(r):
    m = _nonempty(r, "searchphrase")
    _, gid, n, out = _by_phrase(r, m)
    out.num("u", count_distinct(gid, _c(r, "userid", m), n))
    return out.host([("u", True), ("searchphrase", False)], 10)


def q14(r):
    m = _nonempty(r, "searchphrase")
    eng, phrase = _c(r, "searchengineid", m), _c(r, "searchphrase", m)
    gid, n = group([eng, phrase])
    out = Result().num("searchengineid", first(eng, gid, n))
    _str(out, r, "searchphrase", first(phrase, gid, n))
    out.num("c", seg_count(gid, n))
    return out.host([("c", True), ("searchengineid", False),
                     ("searchphrase", False)], 10)


def q15(r):
    user = _c(r, "userid")
    gid, n = group([user])
    out = Result().num("userid", first(user, gid, n)).num("c", seg_count(gid, n))
    return out.host([("c", True), ("userid", False)], 10)


def _user_phrase(r):
    user, phrase = _c(r, "userid"), _c(r, "searchphrase")
    gid, n = group([user, phrase])
    out = Result().num("userid", first(user, gid, n))
    _str(out, r, "searchphrase", first(phrase, gid, n))
    return out.num("c", seg_count(gid, n))


def q16(r):
    return _user_phrase(r).host([("c", True), ("userid", False),
                                 ("searchphrase", False)], 10)


def q17(r):
    return _user_phrase(r).host([("userid", False), ("searchphrase", False)], 10)


def q19(r):
    user = _c(r, "userid")
    return Result().num("userid", user[user == Q19_USERID]).host()


def q20(r):
    return Result().num("c", _one(r, r.like(T, "url", "%google%").sum())).host()


def q21(r):
    m = r.like(T, "url", "%google%") & _nonempty(r, "searchphrase")
    _, gid, n, out = _by_phrase(r, m)
    out.string("u", _seg_min(_c(r, "url", m), gid, n), r.dictionary(T, "url"))
    out.num("c", seg_count(gid, n))
    return out.host([("c", True), ("searchphrase", False)], 10)


def q22(r):
    m = (r.like(T, "title", "%Google%") & ~r.like(T, "url", "%.google.%")
         & _nonempty(r, "searchphrase"))
    _, gid, n, out = _by_phrase(r, m)
    out.string("u", _seg_min(_c(r, "url", m), gid, n), r.dictionary(T, "url"))
    out.string("t", _seg_min(_c(r, "title", m), gid, n), r.dictionary(T, "title"))
    out.num("c", seg_count(gid, n))
    out.num("uu", count_distinct(gid, _c(r, "userid", m), n))
    return out.host([("c", True), ("searchphrase", False)], 10)


def _clicks(r, first_key: str, m=None):
    a, ip = _c(r, first_key, m), _c(r, "clientip", m)
    gid, n = group([a, ip])
    cnt = seg_count(gid, n)
    out = (Result().num(first_key, first(a, gid, n))
           .num("clientip", first(ip, gid, n))
           .num("c", cnt)
           .num("r", seg_sum(_c(r, "isrefresh", m), gid, n))
           .num("w", _avg(r, _c(r, "resolutionwidth", m), gid, n, cnt)))
    return out.host([("c", True), (first_key, False), ("clientip", False)], 10)


def q30(r):
    return _clicks(r, "searchengineid", _nonempty(r, "searchphrase"))


def q31(r):
    return _clicks(r, "watchid", _nonempty(r, "searchphrase"))


def q32(r):
    return _clicks(r, "watchid")


def _by_url(r, one: bool):
    url = _c(r, "url")
    gid, n = group([url])
    out = Result()
    if one:
        out.num("one", torch.ones(n, dtype=torch.int64, device=r.device))
    _str(out, r, "url", first(url, gid, n))
    out.num("c", seg_count(gid, n))
    return out.host([("c", True), ("url", False)], 10)


def q33(r):
    return _by_url(r, False)


def q34(r):
    return _by_url(r, True)


def q35(r):
    ip = _c(r, "clientip")
    gid, n = group([ip])
    key = first(ip, gid, n)
    out = Result().num("clientip", key)
    for i in (1, 2, 3):
        out.num(f"ip{i}", key - i)
    out.num("c", seg_count(gid, n))
    return out.host([("c", True), ("clientip", False)], 10)


QUERIES = {name: fn for name, fn in globals().items()
           if name[0] == "q" and name[1:].isdigit()}


class Reference:
    """Runs the reference queries over one dataset."""

    def __init__(self, ds, float_dtype=torch.float64):
        self.r = Ref(ds, float_dtype)

    def run(self, qid, slot_values: dict) -> dict:
        with torch.no_grad():
            return QUERIES[qid](self.r)

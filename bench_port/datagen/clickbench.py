"""ClickBench's ``hits`` table made on the device from a seed, in the
engine's columnar form: the 14 columns the 28 queries of
``queries/clickbench.py`` read, nine int64, one int32 date and four
int32 codes into sorted string dictionaries (92 bytes a row).

``scale`` is in millions of rows: ClickBench's official table is
99,997,497 rows (``scale`` 99.997497).  The shapes follow the port's
sample (``repro_torch/data/clickbench.py``) at the real cardinality, with
every distinct count in proportion to the rows:

- UserID: 17,630,976 distinct at full size (the official answer to
  ``COUNT(DISTINCT UserID)``), 63-bit ids, zipf-skewed (exponent
  ``USER_SKEW``) so that a few users are heavy hitters.  Each user has a
  home region, a client IP (most of their rows), a screen width and a
  phone; q19's literal UserID is one of them.
- SearchPhrase: 6,019,103 distinct at full size, the empty string
  counted (the official answer to ``COUNT(DISTINCT SearchPhrase)``);
  ``PHRASE_SHARE`` of the rows carry a phrase, zipf-skewed.
- URL and Title: ``URLS`` and ``TITLES`` distinct at full size (no
  official query publishes them), zipf-skewed; a page's title is fixed
  by its URL.  ``URL LIKE '%google%'`` is rare: a google host on about
  ``GOOGLE_URLS`` of the URLs outside the ``TOP_PLAIN`` most visited.
- WatchID: 63-bit ids, unique but for ``REPEATS`` of the rows, which
  repeat another row's WatchID and ClientIP (a reload).
- EventDate: July 2013.

Every distinct value of UserID, SearchPhrase, URL and Title is on at
least one row: the first rows of a key's draw go one to each value, the
rest follow the skew, and a permutation from the seed spreads them over
the table.  String tokens render in sorted order, so no host sort runs.
"""
from __future__ import annotations

import numpy as np
import torch

from .encode import Dataset, Draw, days, digits, words_render

FULL_ROWS = 99_997_497
USERS = 17_630_976            # COUNT(DISTINCT UserID), official
PHRASES = 6_019_103           # COUNT(DISTINCT SearchPhrase), official ('' included)
URLS = 4_000_000              # assumed
TITLES = 2_000_000            # assumed
PHRASE_SHARE = 0.13           # rows with a search phrase
USER_SKEW, PHRASE_SKEW, URL_SKEW = 0.9, 0.8, 0.9
MOBILE_SHARE = 0.1            # users on a phone
MODELS = 200                  # MobilePhoneModel values besides ''
ADV_SHARE = 0.0063            # rows with AdvEngineID <> 0
REFRESH_SHARE = 0.07
REPEATS = 0.001               # rows repeating another row's WatchID
GOOGLE_URLS = 2e-4            # URLs on a google host, past TOP_PLAIN
TOP_PLAIN = 1000
GOOGLE_TITLES = 0.002         # titles ending in "- Google"
IP_SHARE = 0.8                # rows from the user's own client IP
Q19_USERID = 435090932899640449
DAY0 = days("2013-07-01")
T = "hits"

SYLLABLES = ["ba", "do", "fi", "ga", "ke", "lu", "ma", "ni", "po", "ra",
             "se", "ta", "vo", "za", "cho", "pre", "stu", "tri", "wen", "xo"]
WORDS = sorted({a + b for a in SYLLABLES for b in SYLLABLES})   # 400
TLDS = ["com", "net", "org", "ru", "ua"]
GOOGLE_HOSTS = ["google.com", "google.ru", "images.google.com",
                "mail.google.com", "news.google.ru", "translate.google.com",
                "www.google.com", "www.google.ru"]
PATHS = sorted(["blog", "cars", "catalog", "chat", "films", "forum", "games",
                "images", "maps", "market", "music", "news", "search",
                "sport", "video", "weather"])
BRANDS = sorted(["Auto.ru", "Avito", "Bing", "Google", "Kinopoisk", "Mail.Ru",
                 "RuTube", "VK", "Wikipedia", "Yandex"])
WIDTHS = [0, 1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560]
WIDTH_P = [0.08, 0.1, 0.18, 0.22, 0.1, 0.08, 0.1, 0.12, 0.02]
ENGINES = 40                  # SearchEngineID 1..40 on rows with a phrase
ADV_ENGINES = 30
REGIONS = 229
ID_DIGITS = 8


def scaled(count: int, n: int) -> int:
    """``count`` at ``n`` rows in place of the official table's."""
    return max(1, round(count * n / FULL_ROWS))


def hosts() -> list:
    """Sorted hosts, the google ones among them: none is a prefix of
    another, so ``<host>/...`` sorts as the host does."""
    plain = [f"{w}.{t}" for w in WORDS[::4] for t in TLDS]
    return sorted(set(plain) | set(GOOGLE_HOSTS))


def zipf(draw: Draw, m: int, n: int, s: float) -> torch.Tensor:
    """``n`` ranks in [0, m), P(r) about (r + 1)^-s (the continuous
    power law's inverse CDF, s < 1)."""
    u = draw.random(n)
    x = ((m ** (1 - s) - 1) * u + 1) ** (1 / (1 - s))
    return (x.floor().to(torch.int64) - 1).clamp_(0, m - 1)


def covered(draw: Draw, m: int, n: int, s: float) -> torch.Tensor:
    """``n`` draws of [0, m) (n >= m) on which every value occurs: m rows
    take each value once, the rest follow ``zipf``, in an order from the
    seed."""
    idx = torch.cat([torch.randperm(m, generator=draw.g, device=draw.device),
                     zipf(draw, m, n - m, s)])
    return idx[torch.randperm(n, generator=draw.g, device=draw.device)]


def distinct(draw: Draw, lo: int, hi: int, m: int) -> torch.Tensor:
    """``m`` distinct int64 values drawn from [lo, hi), in an order from
    the seed: draws with a margin for the repeats expected (about
    m^2 / 2 (hi - lo)), then a random ``m`` of the distinct ones."""
    extra = 2 * m * m // (hi - lo) + m // 64 + 64
    vals = torch.unique(draw.integers(lo, hi, m + extra))
    if vals.numel() < m:
        raise RuntimeError("too few distinct draws")
    return vals[torch.randperm(vals.numel(), generator=draw.g,
                               device=draw.device)[:m]]


def choice(draw: Draw, p, n: int) -> torch.Tensor:
    """``n`` indices into ``p`` (probabilities)."""
    w = torch.tensor(p, dtype=torch.float64, device=draw.device)
    return torch.multinomial(w, n, replacement=True, generator=draw.g)


def _phrase_render(tok: np.ndarray):
    """Sorted distinct tokens of three words (base len(WORDS)); -1, first
    where it is present, is ''."""
    words = words_render(WORDS, 3)
    if len(tok) and tok[0] < 0:
        return np.concatenate([np.asarray([""]), words(tok[1:])])
    return words(tok)


def _model_names() -> list:
    return sorted(f"{b} {m}" for b in ("Galaxy", "HTC", "Lumia", "Nexus",
                                       "Xperia", "iPad", "iPhone", "Moto")
                  for m in range(1, MODELS // 8 + 1))


def generate(scale: float, seed: int, device) -> Dataset:
    draw = Draw(seed, device)
    dev = draw.device
    n = int(round(scale * 1_000_000))
    ds = Dataset()
    i64 = dict(dtype=torch.int64, device=dev)

    # users and what each one keeps: region, client IP, screen, phone
    n_users = scaled(USERS, n)
    uid = distinct(draw, 0, 2**63 - 1, n_users)
    uid[n_users // 4] = Q19_USERID
    u_region = 1 + zipf(draw, REGIONS, n_users, 0.7)
    u_ip = draw.integers(-2**31, 2**31, n_users)
    u_width = torch.tensor(WIDTHS, **i64)[choice(draw, WIDTH_P, n_users)]
    models = _model_names()
    mobile = draw.random(n_users) < MOBILE_SHARE
    u_model = torch.where(mobile, 1 + zipf(draw, len(models), n_users, 0.6),
                          torch.zeros(n_users, **i64))
    u_phone = torch.where(mobile, draw.integers(1, 90, n_users),
                          torch.zeros(n_users, **i64))
    user = covered(draw, n_users, n, USER_SKEW)
    ds.add(T, "userid", uid[user], "numeric")
    del uid
    ds.add(T, "regionid", u_region[user], "numeric")
    own_ip = draw.random(n) < IP_SHARE
    clientip = torch.where(own_ip, u_ip[user], draw.integers(-2**31, 2**31, n))
    del own_ip, u_ip
    ds.add(T, "resolutionwidth", u_width[user], "numeric")
    ds.add(T, "mobilephone", u_phone[user], "numeric")
    names = np.asarray([""] + models)
    ds.add_strings(T, "mobilephonemodel", u_model[user],
                   lambda t: names[t], ordered=True)
    del user, u_region, u_width, u_phone, u_model

    # WatchID: unique but for the reloads, which repeat a row's WatchID
    # and ClientIP
    watchid = distinct(draw, 0, 2**63 - 1, n)
    again = torch.nonzero(draw.random(n) < REPEATS).flatten()
    src = draw.integers(0, n, again.numel())
    watchid[again] = watchid[src]
    clientip[again] = clientip[src]
    ds.add(T, "watchid", watchid, "numeric")
    ds.add(T, "clientip", clientip, "numeric")
    del watchid, clientip, again, src

    adv = draw.random(n) < ADV_SHARE
    ds.add(T, "advengineid",
           torch.where(adv, 1 + zipf(draw, ADV_ENGINES, n, 0.8),
                       torch.zeros(n, **i64)), "numeric")
    ds.add(T, "isrefresh", (draw.random(n) < REFRESH_SHARE).long(),
           "numeric")
    ds.add(T, "eventdate",
           (DAY0 + draw.integers(0, 31, n)).to(torch.int32), "date")
    del adv

    # search phrases: three words, on PHRASE_SHARE of the rows
    n_phr = scaled(PHRASES, n) - 1
    with_phrase = max(n_phr, round(PHRASE_SHARE * n))
    space = len(WORDS) ** 3
    p_tok = distinct(draw, 0, space, n_phr)
    rows = torch.randperm(n, generator=draw.g, device=dev)[:with_phrase]
    phrase = torch.full((n,), -1, **i64)
    phrase[rows] = p_tok[covered(draw, n_phr, with_phrase, PHRASE_SKEW)]
    engine = torch.zeros(n, **i64)
    engine[rows] = 1 + zipf(draw, ENGINES, with_phrase, 0.9)
    ds.add_strings(T, "searchphrase", phrase, _phrase_render, ordered=True)
    ds.add(T, "searchengineid", engine, "numeric")
    del p_tok, rows, phrase, engine

    # pages: URL "<scheme>://<host>/<path>?id=<rank>" and its title
    # "<three words> - <brand>"
    n_url = scaled(URLS, n)
    host_list = hosts()
    google = torch.tensor([h in GOOGLE_HOSTS for h in host_list], device=dev)
    plain_idx = torch.nonzero(~google).flatten()
    google_idx = torch.nonzero(google).flatten()
    host = plain_idx[zipf(draw, plain_idx.numel(), n_url, 0.7)]
    rank = torch.arange(n_url, **i64)
    goog = (draw.random(n_url) < GOOGLE_URLS) & (rank >= TOP_PLAIN)
    host = torch.where(goog, google_idx[draw.integers(0, google_idx.numel(), n_url)],
                       host)
    scheme = (draw.random(n_url) < 0.3).long()          # 0 http, 1 https
    path = draw.integers(0, len(PATHS), n_url)
    ids = 10 ** ID_DIGITS
    url_tok = ((scheme * len(host_list) + host) * len(PATHS) + path) * ids + rank
    n_title = scaled(TITLES, n)
    t_words = distinct(draw, 0, len(WORDS) ** 3, n_title)
    brand = torch.where(draw.random(n_title) < GOOGLE_TITLES,
                        BRANDS.index("Google"),
                        choice(draw, [0.0 if b == "Google" else 1.0
                                      for b in BRANDS], n_title))
    t_tok = t_words * len(BRANDS) + brand
    page_title = torch.cat([torch.randperm(n_title, generator=draw.g,
                                           device=dev)[:min(n_title, n_url)],
                            draw.integers(0, n_title, max(n_url - n_title, 0))])
    del host, goog, scheme, path, t_words, brand
    page = covered(draw, n_url, n, URL_SKEW)
    schemes = np.asarray(["http://", "https://"])
    hs = np.asarray(host_list)
    ps = np.asarray(PATHS)
    hp = len(host_list) * len(PATHS)

    def url_render(tok: np.ndarray):
        t = tok.astype(np.int64)
        head = t // ids
        s = np.char.add(schemes[head // hp], hs[head // len(PATHS) % len(host_list)])
        s = np.char.add(np.char.add(s, "/"), ps[head % len(PATHS)])
        tail = np.char.add("?id=", digits(t % ids, ID_DIGITS).view(
            f"S{ID_DIGITS}").ravel().astype(f"U{ID_DIGITS}"))
        return np.char.add(s, tail)
    ds.add_strings(T, "url", url_tok[page], url_render, ordered=True)
    del url_tok
    words3 = words_render(WORDS, 3)
    bs = np.asarray(BRANDS)

    def title_render(tok: np.ndarray):
        t = tok.astype(np.int64)
        return np.char.add(np.char.add(words3(t // len(BRANDS)), " - "),
                           bs[t % len(BRANDS)])
    ds.add_strings(T, "title", t_tok[page_title[page]], title_render,
                   ordered=True)
    return ds

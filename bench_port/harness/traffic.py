"""The one traffic generator: reads a mix's parameters
(``traffic/<mix>.json``) and yields the configuration's queries.

A mix sets ``warm_passes``: passes over every query before the window,
counted as set-up (each a cold run that records its plan).  Every query
carries the configuration's parameters at the cell's scale
(``queries.parameters``).  Each pass runs every query of the set once, in
an order drawn from the seed.  The client is closed-loop and single: the
next query is sent when the last answer is on the host.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Tuple

import numpy as np

MASK = (1 << 63) - 1
ORDER_STREAM, WARM_STREAM = 2, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & MASK, stream])


class Stream:
    def __init__(self, mix: dict, queries, seed: int, scale: float):
        self.mix = mix
        self.q = queries
        self.seed = seed
        self.scale = scale

    def _passes(self, order_rng) -> Iterator[Tuple[object, dict]]:
        ids = list(self.q.IDS)
        for _ in itertools.count():
            for i in order_rng.permutation(len(ids)):
                qid = ids[int(i)]
                yield qid, self.q.parameters(qid, self.scale)

    def warm(self) -> List[Tuple[object, dict]]:
        n = int(self.mix.get("warm_passes", 0)) * len(self.q.IDS)
        return list(itertools.islice(self._passes(rng(self.seed, WARM_STREAM)), n))

    def window(self) -> Iterator[Tuple[object, dict]]:
        return self._passes(rng(self.seed, ORDER_STREAM))

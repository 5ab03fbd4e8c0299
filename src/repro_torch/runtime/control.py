"""Distributed control plane (simulated): heartbeats, failures, stragglers —
counterpart of ``repro/runtime/control.py``.

The paper delegates the control plane to the host database's coordinator
(§3.2.1): liveness via heartbeat, fragment scheduling, partitioning decisions,
global metadata.  This module provides that substrate for our coordinator,
plus the fault-tolerance hooks the paper lists as future work (§3.4) — which
we implement: fragment retry, checkpoint/restart, elastic downsizing and
speculative straggler re-execution.

Hardware failures cannot occur in a CPU container, so failures/stragglers are
*injected* deterministically; the recovery machinery they exercise is real.

One departure from the reference, in ``SpeculativeRunner``: a replica that
wakes from its injected delay after the other replica's result was taken
returns without running the fragment, and the replicas of one runner run
their bodies one at a time under its lock.  The fragments launch device
work on one engine pool whose kernel workspaces are shared, so a late
replica must not run while later fragments do.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Set


class SimulatedNodeFailure(RuntimeError):
    def __init__(self, node: int, fragment: str):
        super().__init__(f"node {node} failed during fragment {fragment!r}")
        self.node = node
        self.fragment = fragment


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault schedule: fail `node` when `fragment` runs."""

    fragment: str
    node: int = 0
    times: int = 1            # how many executions of that fragment to kill
    delay_s: float = 0.0      # straggler injection instead of failure

    def is_failure(self) -> bool:
        return self.delay_s == 0.0


class FaultInjector:
    def __init__(self, plans: Optional[List[FaultPlan]] = None):
        self.plans = list(plans or [])
        self.tripped: List[str] = []

    def before_fragment(self, fragment: str) -> None:
        for p in self.plans:
            if p.fragment == fragment and p.times > 0 and p.is_failure():
                p.times -= 1
                self.tripped.append(fragment)
                raise SimulatedNodeFailure(p.node, fragment)

    def straggle(self, fragment: str) -> float:
        """Returns injected delay (seconds) for this fragment, if any."""
        for p in self.plans:
            if p.fragment == fragment and p.times > 0 and not p.is_failure():
                p.times -= 1
                self.tripped.append(fragment)
                return p.delay_s
        return 0.0


class HeartbeatMonitor:
    """Liveness registry for logical nodes (paper §3.2.1 'identify active
    nodes via heartbeat').  Nodes post beats; the failure detector marks a
    node dead after `timeout_s` of silence or an explicit kill."""

    def __init__(self, n_nodes: int, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self.last_beat: Dict[int, float] = {i: time.monotonic()
                                            for i in range(n_nodes)}
        self.killed: Set[int] = set()
        self._lock = threading.Lock()

    def beat(self, node: int) -> None:
        with self._lock:
            if node not in self.killed:
                self.last_beat[node] = time.monotonic()

    def kill(self, node: int) -> None:
        with self._lock:
            self.killed.add(node)

    def revive_all(self) -> None:
        with self._lock:
            self.killed.clear()
            now = time.monotonic()
            for k in self.last_beat:
                self.last_beat[k] = now

    def live_nodes(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return [n for n, t in self.last_beat.items()
                    if n not in self.killed and now - t < self.timeout_s]


class SpeculativeRunner:
    """Straggler mitigation: run the fragment; if it exceeds `budget_s`,
    launch a backup replica and take whichever finishes first (fragments are
    deterministic, so either result is valid).

    A replica runs its body under the runner's lock, and only while no
    result has been taken: the primary that wakes from its delay after the
    backup won never runs the fragment."""

    def __init__(self, budget_factor: float = 3.0, min_budget_s: float = 0.5):
        self.budget_factor = budget_factor
        self.min_budget_s = min_budget_s
        self.history: Dict[str, float] = {}
        self.speculated: List[str] = []
        self._lock = threading.Lock()

    def run(self, name: str, fn: Callable[[], object],
            injected_delay_s: float = 0.0,
            wrap: Optional[Callable[[str, Callable[[], object]], object]] = None):
        """``wrap``, when given, is called as ``wrap(who, fn)`` on the
        replica's own thread — the hook the coordinator uses to carry its
        journal trace context onto primary/backup threads (fragments run
        on spawned threads, so ambient thread-local context doesn't
        follow by itself)."""
        budget = max(self.min_budget_s,
                     self.budget_factor * self.history.get(name, 0.0))
        result: Dict[str, object] = {}
        done = threading.Event()

        def runner(who: str, delay: float):
            def go():
                if delay:
                    time.sleep(delay)
                with self._lock:
                    if done.is_set():
                        return      # the other replica's result was taken
                    try:
                        r = wrap(who, fn) if wrap is not None else fn()
                    except BaseException as e:  # noqa: BLE001 — re-raised below
                        result.setdefault("error", e)
                        result.setdefault("who", who)
                        done.set()
                        return
                    result.setdefault("value", r)
                    result.setdefault("who", who)
                    done.set()
            return go

        t0 = time.monotonic()
        pthread = threading.Thread(target=runner("primary", injected_delay_s),
                                   daemon=True)
        pthread.start()
        pthread.join(timeout=budget)
        if not done.is_set():
            # primary is straggling → speculative backup (no injected delay)
            self.speculated.append(name)
            bthread = threading.Thread(target=runner("backup", 0.0),
                                       daemon=True)
            bthread.start()
            done.wait()
        elapsed = time.monotonic() - t0
        # track the non-straggling duration estimate
        self.history[name] = min(self.history.get(name, elapsed), elapsed)
        if "error" in result:
            # fragments are deterministic: first finisher's error is the
            # fragment's error (coordinator handles retry/elastic)
            raise result["error"]
        return result["value"], result.get("who", "primary")

"""Closed-loop traffic: ``clients`` gates, each sending its next query when
the previous answer has arrived, with no think time.

The server answers requests in the mix's fixed ``cycle`` of kinds; request
r sends pool query ``(r + r // len(cycle)) % pool``, so that every query
comes round to every kind (the pool and ``len(cycle) + 1`` share no
factor).  Requests are sent while
the window's ``seconds`` last, for one whole cycle at least, and a traced
run goes on until its slice is whole.  Each request is timed from its send
to its answer's arrival in host memory.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class Done:
    r: int
    kind: str
    query: int
    sent: float
    arrived: float

    @property
    def latency(self) -> float:
        return self.arrived - self.sent


def kind_and_query(traffic: dict, r: int):
    cycle = traffic["cycle"]
    return cycle[r % len(cycle)], (r + r // len(cycle)) % traffic["pool"]["queries"]


def _check(traffic: dict) -> None:
    if traffic.get("clients", 1) != 1:
        raise ValueError("the closed-loop driver serves one client; more need a driver "
                         "that hands the server every pending query")
    if math.gcd(len(traffic["cycle"]) + 1, traffic["pool"]["queries"]) != 1:
        raise ValueError("the cycle's length plus one and the pool share a factor: "
                         "some query would never be sent as some kind")


def warm_up(server, traffic: dict, allocations: Optional[Callable[[], int]]) -> List[int]:
    """Serve the mix's own sequence of requests before the window, whole
    cycles of it, until ``warmup["settle"]`` requests in a row have made no
    new device allocation, or ``warmup["max"]`` requests have been served;
    one cycle where the device counts no allocations (``allocations``
    None; else it counts them so far).  -> the allocations each request
    made."""
    _check(traffic)
    spec, n = traffic["warmup"], len(traffic["cycle"])
    made: List[int] = []
    quiet = 0  # requests in a row with no allocation
    r = 0
    while r % n or not r or (allocations is not None and quiet < spec["settle"]
                             and r < spec["max"]):
        before = allocations() if allocations else 0
        server.request(*kind_and_query(traffic, r))
        made.append((allocations() if allocations else 0) - before)
        quiet = 0 if made[-1] else quiet + 1
        r += 1
    return made


def serve(server, traffic: dict, seconds: float, hooks) -> Tuple[float, List[Done]]:
    """Run the window; return its start and its requests.
    ``server.request(kind, query)`` returns once the answer is in host
    memory; ``hooks.before(r)`` / ``hooks.after(r)`` run around each
    request outside its timing, and ``hooks.pending()`` keeps the window
    open past ``seconds`` while it is true."""
    _check(traffic)
    done: List[Done] = []
    t0 = time.perf_counter()
    r = 0
    while time.perf_counter() - t0 < seconds or r < len(traffic["cycle"]) or hooks.pending():
        kind, q = kind_and_query(traffic, r)
        hooks.before(r)
        sent = time.perf_counter()
        server.request(kind, q)
        arrived = time.perf_counter()
        hooks.after(r)
        done.append(Done(r, kind, q, sent, arrived))
        r += 1
    return t0, done

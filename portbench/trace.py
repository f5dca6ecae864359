"""The traced slice of a run: the device operations and host events that
``torch.profiler`` recorded over a few served requests, reduced to plain
records that the per-layer readers (``portbench/metrics/``) read.

Times are seconds on the profiler's clock.  A device operation's launch
time is the start of the CUDA runtime call that shares its correlation id;
the harness's own ranges (``portbench.*``, ``record_function``) mark the
slice, each request and the layers it wraps.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import stats

SLICE = "portbench.slice"
HARNESS_PREFIX = "portbench."
_KERNEL_NAME = re.compile(r"([A-Za-z_]\w*_kernel)\b")
_RUNTIME_CALL = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


@dataclasses.dataclass
class Op:
    """One operation that ran on the device."""
    name: str
    start: float
    end: float
    launch: Optional[float] = None  # when the host launched it

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Span:
    """One host event: a harness range, a library operator or a runtime call."""
    name: str
    start: float
    end: float


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters; any other name as it is, cut to 80 characters."""
    m = _KERNEL_NAME.search(name)
    return m.group(1) if m else name[:80]


@dataclasses.dataclass
class Slice:
    """What a traced slice of served requests holds.

    ops, host: the device operations and host events inside the slice;
    lo, hi: the slice's bounds; requests: the requests it served.
    counts: kernel launches by the program's counters over the whole
    measured window, window_requests: the requests of that window.
    ntt_launches: K1's launches in the slice as (rows, limbs) -> launches,
    and ntt_rows_hist: the program's ``NttPlan.rows_hist`` over the slice.
    untraced_s: the seconds the slice's requests take with no profiler on
    (each the mean latency of the window's untraced requests of its kind).
    """
    ops: List[Op]
    host: List[Span]
    lo: float
    hi: float
    requests: int
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    window_requests: int = 0
    ntt_launches: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)
    ntt_rows_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    ring_dim: int = 0
    untraced_s: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return stats.union_length(((o.start, o.end) for o in self.ops), self.lo, self.hi)

    def device_s(self, keep: Callable[[Op], bool]) -> float:
        """Device seconds of the operations that ``keep`` selects."""
        return sum(o.seconds for o in self.ops if keep(o))

    def launched_in(self, range_name: str) -> Callable[[Op], bool]:
        """A selector of the operations launched inside a host range of
        that name (an operation with no launch time: started inside it)."""
        ranges = [(s.start, s.end) for s in self.host if s.name == range_name]

        def keep(o: Op) -> bool:
            t = o.start if o.launch is None else o.launch
            return any(s <= t < e for s, e in ranges)
        return keep

    def per_request_ms(self, seconds: float) -> float:
        return seconds / self.requests * 1e3

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took the most time, by short name."""
        by = defaultdict(float)
        for o in self.ops:
            by[short_name(o.name)] += o.seconds
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the slice, by what the host was doing
        when each gap began: the innermost harness range and the innermost
        other host event open then; the names with the most idle time."""
        by = defaultdict(float)
        harness = _Opened([s for s in self.host if s.name.startswith(HARNESS_PREFIX)])
        other = _Opened([s for s in self.host if not s.name.startswith(HARNESS_PREFIX)])
        for g0, g1 in stats.gaps(((o.start, o.end) for o in self.ops), self.lo, self.hi):
            by[harness.innermost(g0) + " > " + other.innermost(g0)] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class _Opened:
    """The innermost of a set of host events open at a time: the latest
    started of those that contain it, looked for among the ``LOOK_BACK``
    events that started last before it ("-" when none of them is open,
    as when Python runs between two calls)."""

    LOOK_BACK = 64

    def __init__(self, spans: Sequence[Span]):
        self.spans = sorted(spans, key=lambda s: s.start)
        self.starts = [s.start for s in self.spans]

    def innermost(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for s in reversed(self.spans[max(0, i - self.LOOK_BACK):i]):
            if t < s.end:
                return s.name
        return "-"


def from_events(events, **fields) -> Slice:
    """The slice of profiler events given as (name, on_device, start_s,
    end_s, correlation id): bounded by the host range ``SLICE``.  A device
    event named as a host event is that range's mark on the device's
    timeline (the profiler's user annotations), not work: left out."""
    host, dev, launches = [], [], {}
    for name, on_device, s, t, cid in events:
        if on_device:
            dev.append((name, s, t, cid))
            continue
        host.append(Span(name, s, t))
        if _RUNTIME_CALL.match(name):
            launches[cid] = s
    bounds = [sp for sp in host if sp.name == SLICE]
    if len(bounds) != 1:
        raise RuntimeError(f"the trace holds {len(bounds)} ranges named {SLICE}")
    lo, hi = bounds[0].start, bounds[0].end
    names = {sp.name for sp in host}
    ops = [Op(name, s, t, launches.get(cid)) for name, s, t, cid in dev
           if t > lo and s < hi and name not in names]
    host = [sp for sp in host if sp.end > lo and sp.start < hi]
    return Slice(ops=ops, host=host, lo=lo, hi=hi, **fields)


def from_profiler(prof, **fields) -> Slice:
    """The slice that a ``torch.profiler.profile`` recorded (its events'
    times in microseconds, a runtime call and the work it launched sharing
    a correlation id)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return from_events(((e.name, e.device_type == cuda, e.time_range.start * 1e-6,
                         e.time_range.end * 1e-6, e.id) for e in prof.events()), **fields)

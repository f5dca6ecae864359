"""Spans of the served request on ``torch.profiler``'s clock.

``span(name, args)`` marks a stretch of host code as ``imtpu.<name>`` in
the profiler's trace, beside the kernel and copy records that CUPTI puts
on the same clock, so a reader of the trace can tell which device work a
stage launched and where the device waited for the host.  The spans of
one request carry its id in their ``args``:

- ``imtpu.membership``, ``imtpu.index`` (``MatchingProtocol``): one served
  request; ``request`` (``REQUESTS``, advanced on every request, traced or
  not), ``approach`` and ``cts``, the query's ciphertexts;
- ``imtpu.query`` (the streamed senders): the query's preparation before
  the first group, ``cts`` its ciphertexts (HyDia's baby-step rotations,
  HERS's stack of its ciphertexts);
- ``imtpu.group`` (the streamed senders): one group's work, ``g`` and its
  ``tier`` (resident, host, peer or pad); it closes before the score is
  handed on, so no compare falls inside it;
- ``imtpu.score`` (``senders.diag_group_score``, the streamed HERS
  group): relinearization, rotations and rescale of one group's score;
- ``imtpu.compare`` (``Sender._compare_many_with``, ``_compare_stack``):
  one compare circuit, ``scores`` the scores it stacks.

A span is recorded only while a profiler records; otherwise ``span``
returns one shared context manager that does nothing, and ``args`` is not
read.  The trace writes ``args`` under the event's own when the profiler
records shapes (``record_shapes=True``): they are the keyword values of
the profiler's fast record function, as torch's own annotated kernel
launches pass them (``record_function`` records its string argument as an
operator input, which the Chrome trace leaves out).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional

import torch

PREFIX = "imtpu."
REQUESTS = itertools.count()  # the next request id: ``next(REQUESTS)``
_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[dict] = None):
    """The context manager of span ``imtpu.<name>`` with ``args`` (a dict
    of ints and strings), or a shared no-op one while no profiler
    records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name, (), args or {})

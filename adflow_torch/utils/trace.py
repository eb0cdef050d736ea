"""Spans and counters at the layer boundaries of the port's solve loops.

A span is one piece of work at a layer boundary: an API call, a Newton
step, a GMRES iteration, a matvec, a PC build or apply, a halo fill, a BC
pass, a multigrid cycle, the work of one visit to a level, a transfer
between levels, a residual smoothing. Each records its name, its start and end from ``time.time_ns()``
(the clock of ``torch.profiler``'s events, so that spans and device
events can be joined), its own id, its parent's id, the id of its root
API call, and the counters below at its entry and exit.

Spans are recorded only while a ``torch.profiler`` session is active
(``torch.autograd._profiler_enabled()``): the benchmark's profiled unit
and ``jaxProfileDir``. With no profiler running, entering a span costs
that one check and records nothing. While recording, each span is also
pushed as a ``torch.profiler.record_function`` range, so a profile of the
CPU activity shows it beside the device's operations; one of the device
activity alone gains no event by it.

The spans of the latest profiler session are kept in memory: the buffer
is cleared at the first span entered after the profiler was off, holds at
most ``CAP`` spans and counts what it drops. The tracer serves the
thread that runs the solve.

Counters always count: ``host_syncs``, every device-to-host copy of the
solve loops (``host_sync()`` where the copy is made), beside the kernels'
``LAUNCHES`` (K1's, K2's, the BC pass's, ``bc_launches``, and the
residual smoothing's, ``irs_launches``), the Newton functions' exact
residual evaluations, and the RK iterations (``rk_iterations``, eager or
replayed) with the CUDA graph replays and captures among them
(``rk_graph_replays``, ``rk_graph_captures``; ``solvers/rk_graph.py``).
``WORK`` is the one table of the counters that a piece of work advances
(``host_syncs`` and the kernels' ``LAUNCHES``): the spans snapshot it, and
``solvers/rk_graph.py`` sets it back after a capture and credits it at
each replay.
While the current stream captures a CUDA graph no span is recorded: the
capture executes nothing, and a capture is one span of its own
(``smoother.graph_capture``).
"""

from __future__ import annotations

import functools
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.profiler import record_function

from adflow_torch.ops import cuda_bc, cuda_inviscid, cuda_irs, cuda_rans

CAP = 1 << 20

host_syncs = 0
rk_iterations = 0
rk_graph_replays = 0
rk_graph_captures = 0


# the counters work advances, by the name a span snapshots each under:
# (name, module, attribute)
WORK = (("host_syncs", sys.modules[__name__], "host_syncs"),
        ("k1_launches", cuda_rans, "LAUNCHES"),
        ("k2_launches", cuda_inviscid, "LAUNCHES"),
        ("bc_launches", cuda_bc, "LAUNCHES"),
        ("irs_launches", cuda_irs, "LAUNCHES"))


def work_counts() -> Dict[str, int]:
    """The counters of ``WORK`` now, by name."""
    return {name: getattr(mod, attr) for name, mod, attr in WORK}


def set_work_counts(values: Dict[str, int]):
    """Set each counter of ``WORK`` to ``values[name]``."""
    for name, mod, attr in WORK:
        setattr(mod, attr, values[name])


def host_sync(n: int = 1):
    """Count ``n`` device-to-host copies made at the caller's site."""
    global host_syncs
    host_syncs += n


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int               # 0 for a root
    root: int                 # the id of the root API call
    enter: Dict[str, int]     # the counters at entry
    exit: Dict[str, int]      # and at exit

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def count(self, counter: str) -> int:
        """What ``counter`` counted inside the span."""
        return self.exit[counter] - self.enter[counter]


_spans: List[Span] = []
_stack: list = []
_last_id = 0
_off = True
dropped = 0


def spans() -> List[Span]:
    """The spans of the latest profiler session, in the order they ended."""
    return list(_spans)


def _counters(counts) -> Dict[str, int]:
    return {**work_counts(), "rk_iterations": rk_iterations,
            "rk_graph_replays": rk_graph_replays,
            "rk_graph_captures": rk_graph_captures,
            "res_evals": counts["res"] if counts is not None else 0}


class _Open:
    __slots__ = ("name", "counts", "id", "parent", "root", "enter", "t0",
                 "rf")

    def __init__(self, name, counts):
        self.name = name
        self.counts = counts

    def __enter__(self):
        global _off, _last_id, dropped
        if _off:
            _spans.clear()
            dropped = 0
            _off = False
        _last_id += 1
        self.id = _last_id
        if _stack:
            up = _stack[-1]
            self.parent, self.root = up.id, up.root
            if self.counts is None:
                self.counts = up.counts
        else:
            self.parent, self.root = 0, self.id
        _stack.append(self)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.enter = _counters(self.counts)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global dropped
        t1 = time.time_ns()
        counters = _counters(self.counts)
        self.rf.__exit__(*exc)
        _stack.pop()
        if len(_spans) < CAP:
            _spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                               self.root, self.enter, counters))
        else:
            dropped += 1
        return False


class _Closed:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_CLOSED = _Closed()


def span(name: str, counts: Optional[dict] = None):
    """A context manager for one span named ``name``. ``counts``: the Newton
    functions' counts, whose "res" the span and its children snapshot (a
    child takes its parent's). A span entered with no span open is a root:
    its id is the request id of every span under it."""
    global _off
    if not torch.autograd._profiler_enabled():
        _off = True
        return _CLOSED
    if capturing():
        return _CLOSED
    return _Open(name, counts)


def spanned(name: str):
    """Decorate a function: each of its calls is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap

"""CUDA graphs of the RK iteration: the smoother of ``steady.solve_rk`` and
of each multigrid level (``multigrid.rk_smooth``).

Within a solve, one RK iteration launches the same kernels on the same
shapes every time: the halo fills with their BC kernel passes, the time
step, K1 (or K2) at each stage, the smoothing, the stage updates, about 44
device operations a residual evaluation. Issued one by one from the host
they leave the card idle most of the time, so a solve captures one
iteration of each level as a CUDA graph and replays it:

- the first iteration of a key (a level) runs eagerly, as it would without
  graphs; it warms the lazy state (the kernels' libraries, the smoothing's
  line factors, the allocator);
- the second is captured on a side stream, then replayed; every later one
  replays. The state enters through a static copy at each replay (none
  where the caller hands back the graph's own state), the forcing through
  one at each ``force``; the outputs are the graph's own tensors, which
  the next replay overwrites;
- the graphs belong to one solve (``IterationGraphs``), which closes them
  at its end: none replays in another solve. A graph bakes in the Python
  numbers of its iteration (the CFL, the RK coefficients, K1's constants,
  the smoothing's eps) and raw pointers, which stay fixed within a solve
  but not across ``setStates``. Only its temporaries live in its memory
  pool, which the next solve's graph in the same slot shares (``_graph_of``).

``graphable`` decides from the inputs alone where this applies; elsewhere
every iteration runs eagerly. Capture executes nothing, so the counters
of ``trace.WORK`` (the kernels' launches and ``host_syncs``) are set back
after it and each replay adds what the captured iteration counted.
``trace.rk_iterations``, ``rk_graph_replays`` and ``rk_graph_captures``
count how often it engages.
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, Hashable, Optional

import torch

from adflow_torch.physics import bc, residual
from adflow_torch.solvers import smoothers
from adflow_torch.utils import trace


def _residual_takes_kernel(w, metrics, cfg, extras, por) -> bool:
    """Whether a block's whole residual is one kernel: K1, or K2 for an
    inviscid central scalar scheme."""
    if residual._kernel_applies(w, metrics, cfg, extras, por):
        return True
    return (not cfg.viscous and cfg.discretization.startswith("central")
            and "matrix" not in cfg.discretization
            and residual._inviscid_kernel_applies(w, metrics, cfg, por))


def graphable(w_list, metrics_list, topo, cfg, ref, winf, extras_list=None,
              irs_eps: float = 0.0) -> bool:
    """Whether an RK iteration of these inputs can be captured and replayed:
    float32 states on CUDA; autograd recording none of the inputs and no
    ``torch.func`` transform active; the current stream not capturing
    already; every block's BC pass the BC kernel (``bc._kernel_applies``)
    and every residual K1 or K2; the smoothing, where ``irs_eps`` > 0, the
    smoothing kernel (``smoothers._irs_kernel_applies``). The topology's
    exchange is within this process (the several-process layouts have
    steps of their own); an exchange that rotates the momentum copies its
    rotation from the host at each call, and K1 reads a flow constant given
    as a tensor on the host, so neither is captured."""
    if not all(map(bc._kernel_state, w_list)):
        return False
    inputs = [*w_list, winf, *(t for m in metrics_list for t in m
                               if torch.is_tensor(t))]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return False
    if torch._C._are_functorch_transforms_active() or any(
            torch._C._functorch.is_functorch_wrapped_tensor(t)
            for t in (*w_list, winf)):
        return False
    if trace.capturing():
        return False
    if any(op.rotation is not None for op in topo.conn_ops):
        return False
    if torch.is_tensor(ref.mu_inf) or torch.is_tensor(ref.t_inf_dim):
        return False
    for i, (w, m, bs) in enumerate(zip(w_list, metrics_list, topo.blocks)):
        ex = extras_list[i] if extras_list else None
        if not bc._kernel_applies(w, m, bs.bc_ops, ref, winf):
            return False
        if not _residual_takes_kernel(w, m, cfg, ex, bs.por):
            return False
        if irs_eps > 0.0 and not smoothers._irs_kernel_applies(
                w[2:-2, 2:-2, 2:-2]):
            return False
    return True


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The side stream the graphs of ``device`` are captured on."""
    return torch.cuda.Stream(device)


# the last graph captured in each slot (device, index), never replayed
# once its solve is over: the owner of the slot's memory pool, which the
# next graph of the slot shares (PyTorch shares a pool only with a graph
# that is alive), so that a solve's capture reuses the memory of the one
# before it instead of allocating anew
_SLOT_OWNERS = {}
# the iteration that holds each slot while its graph may replay
_SLOT_HOLDERS = weakref.WeakValueDictionary()


def _take_slot(it: "Iteration", device: torch.device) -> tuple:
    """The first slot of ``device`` whose holder is gone or closed: graphs
    that may replay keep distinct pools, so that no replay writes into
    memory that another graph's capture uses."""
    i = 0
    while getattr(_SLOT_HOLDERS.get((device, i)), "graph", None) is not None:
        i += 1
    _SLOT_HOLDERS[device, i] = it
    return device, i


def _graph_of(fn: Callable, slot: tuple):
    """A CUDA graph of ``fn()``, captured on the side stream into the
    memory pool of ``slot``; nothing runs. ``fn`` leaves its results in
    tensors made outside the capture, so the pool holds only the graph's
    temporaries."""
    device = slot[0]
    owner = _SLOT_OWNERS.get(slot)
    stream = _capture_stream(device)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=None if owner is None else owner.pool(),
                            capture_error_mode="thread_local")
        try:
            fn()
        finally:
            # a capture that raised ends too, so that the allocator stops
            # sending allocations to the pool
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    _SLOT_OWNERS[slot] = graph
    return graph


class Iteration:
    """One key's RK iteration within a solve. ``body(w_list, f_list)``
    returns (the new state list, the first stage's residual list); where
    ``graphed``, the first call runs it eagerly, the second captures it and
    replays it, and every later call replays. A replay returns the graph's
    own tensors: its state input, which the replay overwrites with the new
    state (the iteration reads its input only in its first halo fill, which
    copies it), and its residual output. The next replay overwrites both;
    once the solve drops the graph they are plain tensors."""

    def __init__(self, body: Callable, graphed: bool):
        self.body = body
        self.graphed = graphed
        self.eager_runs = 0
        self.graph = None
        self.forcing = None
        self._loaded = False

    def force(self, f_list: Optional[list]):
        """The forcing of the iterations until the next ``force``; copied
        into the graph's input once."""
        self.forcing = f_list
        self._loaded = f_list is None

    def __call__(self, w_list):
        trace.rk_iterations += 1
        if not self.graphed or self.eager_runs == 0:
            self.eager_runs += 1
            w_list, r_list = self.body(w_list, self.forcing)
            self._r_like = [(r.shape, r.dtype, r.device) for r in r_list]
            return w_list, r_list
        if self.graph is None:
            self._capture(w_list)
        else:
            for dst, src in zip(self.w_in, w_list):
                if dst is not src:
                    dst.copy_(src)
            if not self._loaded:
                for dst, src in zip(self.f_in, self.forcing):
                    dst.copy_(src)
                self._loaded = True
        self.graph.replay()
        trace.set_work_counts({k: v + self.deltas[k]
                               for k, v in trace.work_counts().items()})
        trace.rk_graph_replays += 1
        return self.w_in, self.r_out

    def _capture(self, w_list):
        self.w_in = [w.clone() for w in w_list]
        self.f_in = (None if self.forcing is None
                     else [f.clone() for f in self.forcing])
        self._loaded = True
        self.r_out = [torch.empty(shape, dtype=dtype, device=device)
                      for shape, dtype, device in self._r_like]

        def iteration():
            w_new, r_list = self.body(self.w_in, self.f_in)
            for dst, src in zip((*self.w_in, *self.r_out),
                                (*w_new, *r_list)):
                dst.copy_(src)

        before = trace.work_counts()
        slot = _take_slot(self, w_list[0].device)
        with trace.span("smoother.graph_capture"):
            self.graph = _graph_of(iteration, slot)
        self.deltas = {k: v - before[k]
                       for k, v in trace.work_counts().items()}
        trace.set_work_counts(before)
        trace.rk_graph_captures += 1

    def close(self):
        """Drop the graph, which frees its slot."""
        self.graph = None


class IterationGraphs:
    """The RK iterations of one solve, by key. A solve makes one and closes
    it at its end, which drops every graph."""

    def __init__(self):
        self._by_key = {}

    def iteration(self, key: Hashable, body: Callable,
                  gate: Callable[[], bool]) -> Iteration:
        """The iteration of ``key``: made at its first use from ``body``,
        graphed where ``gate()`` holds then; later calls of the same key
        reuse it (and ignore ``body`` and ``gate``)."""
        it = self._by_key.get(key)
        if it is None:
            it = self._by_key[key] = Iteration(body, gate())
        return it

    def close(self):
        for it in self._by_key.values():
            it.close()
        self._by_key.clear()

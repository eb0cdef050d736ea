"""``rk_replay_share``: the RK iterations that replayed a CUDA graph over
all the RK iterations (the program's ``rk_graph_replays`` over its
``rk_iterations``, ``adflow_torch/solvers/rk_graph.py``) inside the
``api.solve`` spans of the profiled unit. None where the program has no
such counters."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    solves = sp and spans.named(sp, "api.solve")
    if not solves or "rk_iterations" not in solves[0].enter:
        return None
    iterations = sum(s.count("rk_iterations") for s in solves)
    replays = sum(s.count("rk_graph_replays") for s in solves)
    return replays / iterations if iterations else None

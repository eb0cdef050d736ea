"""``rk_capture_ms``: the time a solve spends capturing its RK iterations
as CUDA graphs: the program's ``smoother.graph_capture`` spans in the
profiled unit summed, over its ``api.solve`` spans. None where the program
has no such span's counter (``rk_graph_captures``). Host clock."""

from benchmark import spans


def read(ctx, st, records):
    sp = spans.profiled(ctx)
    solves = sp and spans.named(sp, "api.solve")
    if not solves or "rk_graph_captures" not in solves[0].enter:
        return None
    captures = spans.named(sp, "smoother.graph_capture")
    return 1e3 * sum(s.seconds for s in captures) / len(solves)

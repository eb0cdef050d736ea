"""``halo_fill_ms``: one halo fill (the BC passes and the block-to-block
exchange, ``physics/residual.py`` ``fill_halos``) timed alone at the
window's last state (CUDA events, median of 20 after warm-up)."""

from benchmark import harness


def read(ctx, st, records):
    if not ctx.cuda:
        return None
    from adflow_torch.physics.residual import fill_halos
    s = st.solver
    return harness.time_ms(lambda: fill_halos(
        s.w_list, s.metrics_list, s.topo, s.ref, s.winf), reps=20, warmup=2)

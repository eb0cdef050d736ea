from adflow_torch.overset.assembly import (  # noqa: F401
    OversetGroup, OversetTable, apply_overset, build_overset, device_table)

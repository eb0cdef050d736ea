"""The benchmark of adflow_torch: see README.md."""

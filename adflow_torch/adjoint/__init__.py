"""The discrete adjoint (counterpart of adflow_tpu/adjoint)."""

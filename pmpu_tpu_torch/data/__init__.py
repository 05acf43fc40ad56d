"""Data helpers of the port: its own copies of what it needs from
``pmpu_tpu.data`` (which imports jax)."""

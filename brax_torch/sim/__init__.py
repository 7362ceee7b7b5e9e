"""v1 maximal-coordinate PBD physics, batch-first (port of brax_tpu.sim)."""

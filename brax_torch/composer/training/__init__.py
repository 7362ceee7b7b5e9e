"""Trainers over the composer's multi-agent envs (counterpart of
`brax_tpu/composer/training`)."""

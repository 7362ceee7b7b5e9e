"""Counterpart of `brax_tpu/braxlines`: so far only its PPO presets."""

"""Soft actor-critic: counterpart of `brax_tpu/training/agents/sac`."""

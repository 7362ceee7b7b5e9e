"""Trainers and their building blocks: counterpart of `brax_tpu/training`."""

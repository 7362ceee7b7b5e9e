"""The v2 (generalized-coordinate, MuJoCo-style) engine, batch-first.

Counterpart of `brax_tpu/v2/`.  Ported so far: the generalized pipeline
with free/hinge/slide joints, motor actuators and sphere/capsule-plane
contacts, the MJCF loader for what the v2 assets use, and the ant env.
"""

"""Walker2d: a 2D two-legged robot rewarded for walking in +x, batch-first.

Counterpart of `brax_tpu/envs/walker2d.py`: hopper's env (brax_torch/envs/
hopper.py) on the walker's scene (two legs, 6 revolute joints, one-way
capsule-plane contacts of both legs with the floor), healthy while the
torso's z lies in (0.7, 2.0) and its pitch in (-1, 1).  The observation is
17 wide.
"""

from __future__ import annotations

from brax_torch.envs.assets.walker2d import walker2d_config
from brax_torch.envs.hopper import Hopper


class Walker2d(Hopper):
    config = staticmethod(walker2d_config)

    def __init__(self, healthy_z_range=(0.7, 2.0), healthy_angle_range=(-1.0, 1.0), **kwargs):
        super().__init__(healthy_z_range=healthy_z_range,
                         healthy_angle_range=healthy_angle_range, **kwargs)

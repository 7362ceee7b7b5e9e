"""Planar biped on the v2 generalized pipeline, batch-first.

Counterpart of `brax_tpu/v2/envs/walker2d.py`: the hopper's task (forward
reward + healthy bonus - control cost, unhealthy termination) on the
walker body, with its own height and pitch ranges; obs 17 wide.
"""

from __future__ import annotations

from brax_torch.v2.envs import assets
from brax_torch.v2.envs.hopper import Hopper


class Walker2d(Hopper):
    """Planar two-legged walker driving toward +x."""

    XML = staticmethod(assets.walker2d_xml)

    def __init__(self, forward_reward_weight=1.0, ctrl_cost_weight=1e-3, healthy_reward=1.0,
                 terminate_when_unhealthy=True, healthy_z_range=(0.8, 2.0),
                 healthy_angle_range=(-1.0, 1.0), reset_noise_scale=5e-3,
                 exclude_current_positions_from_observation=True, backend="generalized",
                 n_frames=4, batch_size=1, device="cuda", use_kernel=True):
        super().__init__(forward_reward_weight, ctrl_cost_weight, healthy_reward,
                         terminate_when_unhealthy, healthy_z_range, healthy_angle_range,
                         reset_noise_scale, exclude_current_positions_from_observation,
                         backend, n_frames, batch_size, device, use_kernel)

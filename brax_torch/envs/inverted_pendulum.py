"""InvertedPendulum: a cart balancing a pole, batch-first.

Counterpart of `brax_tpu/envs/inverted_pendulum.py`.  `reset` draws the
joint noise (+-0.01) from a `torch.Generator` and hands it to
`reset_from_noise`, which is deterministic, so a test can feed the same
noise to this env and to the JAX one.  The action is 1 wide: the cart's
thruster reads its three columns clipped to that width, (a0, a0, a0), as
the JAX package's jnp path reads them.  The observation (4 wide) is the
cart's x, the pole's angle, the cart's x velocity and the pole's angular
velocity; an episode is done when the pole leans past 0.2 rad.
"""

from __future__ import annotations

import torch

from brax_torch.envs import base
from brax_torch.envs.assets.inverted_pendulum import (
    inverted_pendulum_config, inverted_pendulum_config_spring)
from brax_torch.sim.types import QP, Tensor

NOISE = 0.01


def joint_noise(env: base.Env, rng: torch.Generator, scale: float) -> Tensor:
    """(batch, ndof) uniform draws in [-scale, scale)."""
    shape = (env.batch_size, env.sys.num_joint_dof)
    return torch.rand(shape, generator=rng, device=env.device) * (2 * scale) - scale


class InvertedPendulum(base.Env):

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        config = inverted_pendulum_config_spring() if legacy_spring else inverted_pendulum_config()
        super().__init__(config=config, batch_size=batch_size, device=device)

    def reset(self, rng: torch.Generator) -> base.State:
        qpos_noise = joint_noise(self, rng, NOISE)
        return self.reset_from_noise(qpos_noise, joint_noise(self, rng, NOISE))

    def reset_from_noise(self, qpos_noise: Tensor, qvel_noise: Tensor) -> base.State:
        """The reset state for given joint-angle and joint-velocity noise (N, ndof)."""
        qp = self.default_qp(joint_angle=self.default_angle() + qpos_noise,
                             joint_velocity=qvel_noise)
        zero = torch.zeros(qp.pos.shape[0], device=self.device)
        return base.State(qp, self._get_obs(qp), zero, zero, {})

    def step(self, state: base.State, action: Tensor) -> base.State:
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        reward = torch.ones_like(state.reward)
        done = torch.where(obs[:, 1].abs() > 0.2, 1.0, 0.0)
        return state.replace(qp=qp, obs=obs, reward=reward, done=done)

    @property
    def action_size(self) -> int:
        return 1

    def _get_obs(self, qp: QP) -> Tensor:
        joint_angle, joint_vel = self.sys.joint_angle_vel(qp)
        return torch.cat([qp.pos[:, 0, :1], joint_angle, qp.vel[:, 0, :1], joint_vel], dim=-1)

"""ReacherAngle: the reacher with angle actuators, batch-first.

Counterpart of `brax_tpu/envs/reacherangle.py`.  Its scene drives the two
joints with angle actuators (a PD torque toward a target angle); the env
maps each action in [-1, 1] onto its joint's limits, in degrees, before the
step.  The target's distance is 0.2 times the square root of its draw
(uniform over the disc).  The observation is the reacher's (11 wide); the
reward is minus the tip's distance to the target.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.envs import base
from brax_torch.envs.assets.reacherangle import reacherangle_config, reacherangle_config_spring
from brax_torch.envs.reacher import Reacher
from brax_torch.sim.config import Config
from brax_torch.sim.types import Tensor


class ReacherAngle(Reacher):
    name = "reacherangle"
    metric_names = ("rewardDist", "rewardCtrl")

    def __init__(self, legacy_spring=False, batch_size=1, device="cuda", **kwargs):
        super().__init__(legacy_spring=legacy_spring, batch_size=batch_size, device=device)
        limits = [lim for j in self.art.config.joints for lim in j.angle_limits]
        self._min_act = torch.tensor([lo for lo, _ in limits], device=self.device)
        self._range_act = torch.tensor([hi - lo for lo, hi in limits], device=self.device)

    @staticmethod
    def scene(legacy_spring: bool = False) -> Config:
        return reacherangle_config_spring() if legacy_spring else reacherangle_config()

    def _target(self, draws: Tensor) -> Tensor:
        return super()._target(torch.stack([torch.sqrt(draws[:, 0]), draws[:, 1]], dim=-1))

    def step(self, state: base.State, action: Tensor) -> base.State:
        action = self._min_act + self._range_act * ((action + 1) / 2.0)
        qp, _ = self.sys.step(state.qp, action)
        obs = self._get_obs(qp)
        reward_dist = -maths.safe_norm(obs[:, -3:])
        metrics = {"rewardDist": reward_dist, "rewardCtrl": torch.zeros_like(reward_dist)}
        return state.replace(qp=qp, obs=obs, reward=reward_dist, metrics=metrics)

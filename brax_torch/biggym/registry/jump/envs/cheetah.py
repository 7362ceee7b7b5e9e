"""JumpCheetah: halfcheetah rewarded for takeoff height, not speed
(counterpart of `brax_tpu/biggym/registry/jump/envs/cheetah.py`, batch-first)."""

import torch

from brax_torch.envs import halfcheetah


class JumpCheetah(halfcheetah.Halfcheetah):
    """Reward = torso height gain above standing + airtime bonus - ctrl."""

    STAND_Z = 0.6

    def step(self, state, action):
        state = super().step(state, action)
        qp = state.qp
        z = qp.pos[:, 0, 2]
        zvel = qp.vel[:, 0, 2]
        # all feet off the ground proxy: lowest body above a clearance
        clearance = torch.amin(qp.pos[:, :, 2], dim=1) > 0.25
        reward = (5.0 * torch.clamp(z - self.STAND_Z, min=0.0)
                  + 0.5 * torch.clamp(zvel, min=0.0)
                  + 1.0 * clearance
                  - 0.1 * torch.sum(torch.square(action), dim=-1))
        return state.replace(reward=reward)

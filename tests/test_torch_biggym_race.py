"""biggym's race scenes and jump_cheetah against the JAX package's, on the
CPU: the reset and one step from it (tests/biggym_parity.py: the port's
physics handed to the JAX env; obs, reward and metrics at 1e-3), and
JumpCheetah's reward on a shared state.  race_ant_ant (v1 ant's System
under the race task, the same task code as race_proant_ant) is slow: its
JAX reset jit costs another 5 s."""

import numpy as np
import pytest
import torch

from tests import biggym_parity as bp
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_race_proant_ant_matches_jax():
    state = bp.scene_matches("race_proant_ant", seed=1)
    assert state.reward.shape == (bp.N,)


@pytest.mark.slow  # another JAX reset jit and step jit
def test_race_ant_ant_matches_jax():
    bp.scene_matches("race_ant_ant", seed=2)


def test_jump_cheetah_reward_matches_jax():
    """From halfcheetah's reset (shared noise) and from a state lifted off
    the floor and thrown up (so that the height, the upward speed and the
    clearance terms all count), one step of each package's JumpCheetah."""
    env = bp.port_env("jump_cheetah")
    rs = np.random.RandomState(3)
    noise = lambda: torch.from_numpy(
        rs.uniform(-0.1, 0.1, (bp.N, env.sys.num_joint_dof)).astype(np.float32))
    state = env.reset_from_noise(noise(), noise())
    lift = torch.linspace(0.0, 0.8, bp.N)[:, None]
    up = torch.linspace(-1.0, 3.0, bp.N)[:, None]
    qp = state.qp
    thrown = state.replace(qp=type(qp)(pos=qp.pos + torch.stack(
        [torch.zeros_like(lift), torch.zeros_like(lift), lift], -1), rot=qp.rot,
        vel=qp.vel + torch.stack([torch.zeros_like(up), torch.zeros_like(up), up], -1),
        ang=qp.ang))
    for i, start in enumerate((state, thrown)):
        got = bp.step_matches("jump_cheetah", start, seed=4 + i)
        z, zvel = got.qp.pos[:, 0, 2], got.qp.vel[:, 0, 2]
        want = (5.0 * torch.clamp(z - 0.6, min=0) + 0.5 * torch.clamp(zvel, min=0)
                + (got.qp.pos[:, :, 2].amin(dim=1) > 0.25).float())
        act = np.random.RandomState(4 + i).uniform(-1, 1, (bp.N, 6)).astype(np.float32)
        want = want - 0.1 * torch.from_numpy(act).square().sum(-1)
        torch.testing.assert_close(got.reward, want)
    # the thrown state reaches every term of the reward in some env
    assert bool((got.qp.pos[:, 0, 2] > 0.6).any()) and bool((got.qp.vel[:, 0, 2] > 0).any())
    assert bool((got.qp.pos[:, :, 2].amin(dim=1) > 0.25).any())

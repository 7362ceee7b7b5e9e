"""PPO at the grasp recipe's shape, and the one-way capsule-capsule group
whose body b moves, on the CPU.

grasp's one-way capsule-capsule pair has the frozen palm as body b, so it
cannot show that a one-way group leaves body b alone: pusher's System with
its capsule-capsule pairs made one-way (`pbd_parity.oneway_pusher`, the
object free to move) does, against the JAX package's jnp step on the same
System made alike (brax_tpu/sim/colliders.py's one-way branches of
position_apply and velocity_apply serve any contact type).
"""

import numpy as np
import torch

from brax_torch.sim import colliders, kernels
from brax_torch.tools.pbd_parity import TOLERANCE, capcap_state, fields, one_pass, oneway_pusher

from tests import grasp_parity as gp
from tests.test_torch_pbd_launch import Scene, _config
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_oneway_pair_with_a_moving_body_b_matches_jax():
    """One pass of pusher_oneway from states whose pairs overlap: the twin
    against the JAX jnp pass at TOLERANCE (tests/test_torch_step.py's
    in-contact tolerances, as pusher's own pass is held); neither moves the
    object through those contacts, which the two-way pairs do."""
    from brax_tpu.envs import pusher as jax_pusher

    env = Scene(_config("pusher"), batch_size=gp.N, device="cpu")
    sys = oneway_pusher(env.sys)
    jax_sys = gp.pusher_oneway_jax(jax_pusher.Pusher().sys)
    assert [c.com.one_way for c in jax_sys.contact_groups] == [c.com.one_way
                                                               for c in sys.contact_groups]
    qp, act = capcap_state("pusher", env, gp.N, seed=0, device="cpu")
    out, info = kernels.pbd_step_plain(one_pass(sys), qp, act)
    got = fields(out, info)
    want = gp.jax_step("pusher_oneway", jax_sys, qp, act.numpy(), 1)
    for k, tol in TOLERANCE.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)
    b = int(next(c for c in sys.contact_groups
                 if isinstance(c, colliders.CapsuleCapsule)).com.body_b[0])
    assert not info.contact.vel[:, b].any() and not want["contact_vel"][:, b].any()
    two_way, _ = kernels.pbd_step_plain(one_pass(env.sys), qp, act)
    assert float((two_way.vel[:, b] - out.vel[:, b]).abs().max()) > 0.1


def test_ppo_trains_grasp():
    """One PPO training step at the grasp recipe's shape (unroll 20 cut to
    2, batch 256 to 4) at tiny sizes: the 132-wide observation, the 39-wide
    action (78 policy outputs), the palm's target among them."""
    from brax_torch.training.agents.ppo import train as ppo

    calls = []
    step = kernels.pbd_step_plain

    def counting(sys_, qp, act):
        calls.append(tuple(act.shape))
        return step(sys_, qp, act)

    kernels.pbd_step_plain = counting
    try:
        _, params, metrics = ppo.train(
            "grasp", num_timesteps=16, episode_length=8, num_envs=4, num_eval_envs=2,
            unroll_length=2, batch_size=4, num_minibatches=2, num_updates_per_batch=1,
            num_evals=1, normalize_observations=True, reward_scaling=10.0, discounting=0.99,
            seed=0, device="cpu")
    finally:
        kernels.pbd_step_plain = step
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "eval/episode_reward"):
        assert np.isfinite(metrics[key]), key
    policy = params[1]
    assert policy["hidden_0.kernel"].shape == (132, 32)
    assert policy["hidden_4.kernel"].shape == (32, 78)
    # the rollout: batch 4 x 2 minibatches / 4 envs x unroll 2 = 4 env steps of
    # 4 envs; the evaluation: 8 env steps of 2 envs; one physics step each
    assert calls.count((4, 39)) == 4 and calls.count((2, 39)) == 8

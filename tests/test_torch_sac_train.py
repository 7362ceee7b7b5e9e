"""brax_torch's SAC trainer on the CPU: the counterparts of tests/test_sac.py
(learning `fast`, a params round-trip) and of
tests/test_v2_training.py::test_sac_trains_v2_inverted_pendulum.

The JAX package's learning gate (its hyperparameters, 32,768 SGD steps,
~5 min here) is marked slow, and so is the short check (4096 SGD steps,
64-71 s on one CPU thread), held to SHORT_GATE, set from a CPU run of this port: eval rewards
99.9 / 112.8 / 118.9 at seeds 0 / 1 / 2, against 64.8-70 for the initial
policy (the best policy's reward is ~140).
"""

import pickle

import numpy as np
import pytest
import torch

from brax_torch.training import fused_mlp
from brax_torch.training.agents.sac import train as sac
from brax_torch.v2 import envs as v2_envs

from tests.torch_parity import one_torch_thread  # noqa: F401

SHORT_GATE = 85.0


def _train_fast(seed, **kw):
    args = dict(num_timesteps=2**15, episode_length=128, num_envs=64, learning_rate=3e-4,
                discounting=0.99, batch_size=64, num_evals=3, normalize_observations=True,
                reward_scaling=10, grad_updates_per_step=64, seed=seed, device="cpu")
    args.update(kw)
    return sac.train("fast", **args)


@pytest.mark.slow
def test_sac_learns_fast_env():
    """tests/test_sac.py's gate at its hyperparameters."""
    _, _, metrics = _train_fast(0)
    assert metrics["eval/episode_reward"] > 140 * 0.995


@pytest.mark.slow  # 4096 SGD steps on one CPU thread: 64-71 s, past the 60 s a tier-1 item may take
def test_sac_learns_fast_env_short():
    _, _, metrics = _train_fast(0, num_timesteps=2**13, num_envs=32, num_evals=2,
                                grad_updates_per_step=16)
    assert metrics["eval/episode_reward"] > SHORT_GATE, metrics["eval/episode_reward"]


def test_sac_params_roundtrip():
    make_policy, params, _ = _train_fast(0, num_timesteps=128, num_envs=8, batch_size=8,
                                         num_evals=1, grad_updates_per_step=1, reward_scaling=1)
    params2 = pickle.loads(pickle.dumps(params))
    obs = torch.zeros((1, 2))
    act1, _ = make_policy(params, deterministic=True)(obs, None)
    act2, _ = make_policy(params2, deterministic=True)(obs, None)
    torch.testing.assert_close(act1, act2, rtol=0, atol=0)


def test_sac_trains_v2_inverted_pendulum():
    """Every trainer takes v2 envs through wrap_for_training_any: SAC's
    replay path end to end on the generalized pendulum."""
    env = lambda b, d: v2_envs.get_environment("inverted_pendulum", batch_size=b, device=d)
    make_policy, params, metrics = sac.train(
        env, num_timesteps=512, episode_length=64, num_envs=8, learning_rate=3e-4,
        discounting=0.97, batch_size=16, min_replay_size=64, max_replay_size=1024,
        grad_updates_per_step=1, num_evals=2, num_eval_envs=8, normalize_observations=True,
        seed=0, device="cpu")
    assert np.isfinite(metrics["eval/episode_reward"])
    act, _ = make_policy(params, deterministic=True)(torch.zeros((1, 4)), None)
    assert act.shape == (1, 1)


def test_sac_metrics_counts_and_fused_flag():
    """The JAX trainer's metrics; the buffer's cursors after the last
    training step, averaged over the epoch's steps as JAX averages them;
    env steps counted from the prefill on; the fused kernels' flag on
    during training (the plain bf16 versions on CPU tensors, through the
    critics' 257-wide input) and restored after."""
    seen = []
    fused_mlp.enable(False)
    _, _, metrics = sac.train(
        "humanoid", num_timesteps=48, episode_length=4, num_envs=8, batch_size=8,
        min_replay_size=16, max_replay_size=20, grad_updates_per_step=2, num_eval_envs=4,
        num_evals=1, normalize_observations=True, use_fused_kernel=True, device="cpu",
        progress_fn=lambda step, m: seen.append((step, fused_mlp.enabled())))
    assert seen == [(48, True)] and not fused_mlp.enabled()
    for k in ("critic_loss", "actor_loss", "alpha_loss", "alpha", "sps", "walltime",
              "sps_after_first"):
        assert np.isfinite(metrics[f"training/{k}"]), k
    # 16 rows prefilled, then 4 training steps of 8 into 20 slots: the
    # first and the last roll the ring by 4 and end at 0
    assert metrics["training/buffer_current_size"] == 20
    assert metrics["training/buffer_current_position"] == np.mean([0, 8, 16, 0])
    assert 0 < metrics["training/alpha"] < 1


def test_sac_refuses_what_it_cannot_do():
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        _train_fast(0, num_timesteps=128, checkpoint_dir="build/none")
    with pytest.raises(ValueError, match="no training would happen"):
        _train_fast(0, num_timesteps=128, min_replay_size=128)

"""Full-state checkpoints of the port's PPO and SAC (training/checkpoint.py)
on the CPU: the mirror of tests/test_checkpointing.py (PPO and SAC on
`fast` at its sizes: checkpoints written after each eval, a second run
auto-resumes past the first), the restored state equal to the saved one bit
for bit, and `restore_checkpoint_path` taking precedence over auto-resume."""

import os

import pytest
import torch

from brax_torch.training import checkpoint
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.training.agents.sac import train as sac

from tests.torch_parity import one_torch_thread  # noqa: F401


def _run(agent, ckpt, restore=None):
    steps = []
    progress = lambda step, metrics: steps.append(int(step))
    if agent == "ppo":
        ppo.train("fast", num_timesteps=2048, episode_length=64, num_envs=16, learning_rate=3e-4,
                  entropy_cost=1e-2, discounting=0.95, unroll_length=4, batch_size=16,
                  num_minibatches=2, num_updates_per_batch=1, normalize_observations=True,
                  seed=0, num_evals=3, num_eval_envs=16, checkpoint_dir=ckpt,
                  restore_checkpoint_path=restore, progress_fn=progress, device="cpu")
    else:
        sac.train("fast", num_timesteps=2048, episode_length=64, num_envs=8, learning_rate=3e-4,
                  discounting=0.95, batch_size=16, min_replay_size=32, max_replay_size=512,
                  grad_updates_per_step=1, normalize_observations=True, seed=0, num_evals=3,
                  num_eval_envs=16, checkpoint_dir=ckpt, restore_checkpoint_path=restore,
                  progress_fn=progress, device="cpu")
    return [s for s in steps if s > 0]


@pytest.mark.parametrize("agent", ["ppo", "sac"])
def test_full_state_checkpoint_resume_and_precedence(agent, tmp_path, monkeypatch):
    monkeypatch.setattr(checkpoint, "last_restored", None)
    ckpt = str(tmp_path / agent)
    first = _run(agent, ckpt)
    dirs = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    assert [int(d[5:]) for d in dirs] == first and max(first) >= 2048
    assert checkpoint.last_restored is None
    # a run's first eval lies its first epoch (SAC's prefill included) past its start
    epoch = first[0]

    saved = checkpoint.load(os.path.join(ckpt, dirs[-1]))
    assert saved["env_steps"] == first[-1]
    assert set(saved) == {"env_steps", "params", "optimizers", "normalizer", "generators"}
    assert float(saved["normalizer"]["count"]) > 0
    assert all(len(o["state"]) for o in saved["optimizers"].values())

    # the second run auto-resumes from the newest checkpoint, past the first run
    second = _run(agent, ckpt)
    assert second[0] == first[-1] + epoch and max(second) > max(first), (first, second)
    assert checkpoint.equal(checkpoint.last_restored, saved)

    # restore_checkpoint_path wins over the newest step_* of checkpoint_dir
    third = _run(agent, ckpt, restore=os.path.join(ckpt, dirs[0]))
    assert third[0] == first[0] + epoch, (first, third)
    assert checkpoint.equal(checkpoint.last_restored, checkpoint.load(os.path.join(ckpt, dirs[0])))


def test_equal_is_bitwise():
    a = {"x": torch.tensor([0.0, 1.0]), "n": 3, "l": [torch.zeros(())]}
    assert checkpoint.equal(a, {"x": torch.tensor([0.0, 1.0]), "n": 3, "l": [torch.zeros(())]})
    assert not checkpoint.equal(a, {"x": torch.tensor([-0.0, 1.0]), "n": 3,
                                    "l": [torch.zeros(())]})
    assert not checkpoint.equal(a, {"x": torch.tensor([0.0, 1.0], dtype=torch.float64), "n": 3,
                                    "l": [torch.zeros(())]})
    assert not checkpoint.equal(a, {"x": torch.tensor([0.0, 1.0]), "n": 4,
                                    "l": [torch.zeros(())]})

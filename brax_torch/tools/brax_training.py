"""Humanoid PPO at the fork's published recipe, on one device.

    python -m brax_torch.tools.brax_training [--env humanoid] [--num_timesteps 50000000]
        [--num_envs 2048] [--batch_size 1024] [--logdir build/brax_training] [--seed 1]
        [--device cuda]

Counterpart of the root `brax_training.py`: trains `--env` (the fork's
humanoid by default) with the 50M-step PPO recipe, prints the learning
curve (eval reward at each evaluation), the time from start to the first
training step (set-up, kernel builds and the first evaluation) and the time
of training, and writes the curve to `<logdir>/curve.csv` as `steps,reward`
lines.  `--num_timesteps` scales a run down for a smoke test.  The recipe's
evaluations run every 1.25M env steps (at least 2), as the root script's.

The root script also saves the trained params and an HTML rollout; those
wait for the port's io slice (ROADMAP.md queue A item 10), and this tool
writes neither.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

from brax_torch import cuda_build
from brax_torch.training.agents.ppo import train as ppo


def recipe(args: argparse.Namespace) -> dict:
    """ppo.train's arguments: the root script's recipe for `args`."""
    return dict(
        num_timesteps=args.num_timesteps,
        num_evals=max(2, args.num_timesteps // 1_250_000),
        reward_scaling=0.1,
        episode_length=1000,
        normalize_observations=True,
        action_repeat=1,
        unroll_length=10,
        num_minibatches=32,
        num_updates_per_batch=8,
        discounting=0.97,
        learning_rate=3e-4,
        entropy_cost=1e-3,
        num_envs=args.num_envs,
        batch_size=args.batch_size,
        seed=args.seed,
    )


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--env", default="humanoid")
    parser.add_argument("--num_timesteps", type=int, default=50_000_000)
    parser.add_argument("--num_envs", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--logdir", default=str(cuda_build.BUILD_DIR.parent / "brax_training"))
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, **overrides) -> dict:
    """Runs the recipe; returns the last metrics.  `overrides` replace
    ppo.train arguments of the recipe (a test cuts the evaluations so)."""
    args = parse_args(argv)
    os.makedirs(args.logdir, exist_ok=True)
    times = [time.perf_counter()]
    curve = []

    def progress(num_steps, metrics):
        times.append(time.perf_counter())
        reward = metrics.get("eval/episode_reward")
        curve.append((num_steps, float(reward) if reward is not None else 0.0))
        print(f"steps {num_steps:>12,}  reward {curve[-1][1]:10.1f}", flush=True)

    kwargs = {**recipe(args), **overrides}
    _, _, metrics = ppo.train(args.env, progress_fn=progress, device=args.device, **kwargs)

    print(f"time to first training step: {times[1] - times[0]:.1f} s")
    print(f"time to train: {times[-1] - times[1]:.1f} s")
    with open(os.path.join(args.logdir, "curve.csv"), "w") as f:
        f.writelines(f"{s},{r}\n" for s, r in curve)
    return metrics


if __name__ == "__main__":
    main()

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

As the root script does, it then saves the trained params as
`<logdir>/<env>_params.pkl` (`brax_torch.io.model`) and renders a
rollout of the deterministic policy from one env's reset (a generator
seeded 0), 500 steps or an episode if that is shorter, as
`<logdir>/<env>_rollout.html` (`brax_torch.io.html`), through the
learner CLI's rollout (on CUDA the policy runs on the fused MLP kernels).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch

from brax_torch import cuda_build, envs
from brax_torch.io import html, model
from brax_torch.training import learner
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.v2.base import map_tensors

ROLLOUT_STEPS = 500


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
    make_policy, params, metrics = ppo.train(args.env, progress_fn=progress, device=args.device,
                                             **kwargs)

    print(f"time to first training step: {times[1] - times[0]:.1f} s")
    print(f"time to train: {times[-1] - times[1]:.1f} s")
    model.save_params(os.path.join(args.logdir, f"{args.env}_params.pkl"), params)
    with open(os.path.join(args.logdir, "curve.csv"), "w") as f:
        f.writelines(f"{s},{r}\n" for s, r in curve)

    # render an evaluation rollout
    device = torch.device(args.device)
    eval_env = envs.create(args.env, episode_length=None, auto_reset=False, batch_size=1,
                           device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    qps = learner.rollout(eval_env, make_policy(params, deterministic=True), generator,
                          min(ROLLOUT_STEPS, kwargs["episode_length"]),
                          lambda state: map_tensors(lambda x: x[0], state.qp), until_done=False)
    html.save_html(os.path.join(args.logdir, f"{args.env}_rollout.html"),
                   eval_env.unwrapped.art.config, qps)
    print(f"artifacts saved to {args.logdir}")
    return metrics


if __name__ == "__main__":
    main()

"""RL training CLI: env + trainer selection, TensorBoard metrics, artifacts.

Counterpart of `brax_tpu/training/learner.py`:

    python -m brax_torch.training.learner --learner ppo --env ant --num_envs 2048 ...

`build_parser()` has the JAX CLI's flags, defaults and choices, and
`--device` (default cuda): the run is on the card unless `--device cpu` is
given.  `main(argv)` trains with the port's PPO, SAC, APG, ES or ARS on a
v1 env of `brax_torch.envs` or, with `--engine v2`, a v2 env of
`brax_torch.v2.envs`, writes each evaluation's metrics as TensorBoard
scalars (`brax_torch.io.metrics`; the hparams as `hparams.json`), saves the
params as `<logdir>/<env>_<learner>.pkl` (`brax_torch.io.model`), then
rolls out the trained policy at batch 1 (`auto_reset=False`, its actions
and resets drawn from a generator seeded by `--seed`) `max(--num_videos,
--num_trajectories_npy)` times: v1 rollouts go to
`saved_videos/trajectory_NNNN.html` (`io.html`) and
`saved_qps/trajectory_NNNN.npy` (`io.npy_file`), v2 rollouts to
`saved_videos/` through `brax_torch.v2.io.save_html`.  On CUDA the rollout's
policy runs on the fused MLP kernels, as the trainers' networks do.

`--aot_cache` builds and loads every CUDA library of the run before it
starts (`brax_torch.aot.prebuild`) and prints the seconds.  The JAX CLI's
persistent compilation cache (`enable_compilation_cache`) has no
counterpart: `cuda_build` caches every build on disk by source hash.
`--sweep` waits on braxlines' `experiments.py` and `sweeps.py` (ROADMAP
queue A item 8), and `--backend spring|positional` on the v2 spring and
positional pipelines (queue A item 7): each raises NotImplementedError.

`main` returns what it wrote and what it trained: {"params": path,
"events": event file, "videos": [...], "trajectories": [...],
"rollout_steps": [...], "aot": `prebuild`'s record or None, "make_policy"
and "policy_params": the trainer's}.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from brax_torch import aot, envs
from brax_torch.io import html, metrics, model, npy_file
from brax_torch.training import fused_mlp
from brax_torch.training.agents.apg import train as apg
from brax_torch.training.agents.ars import train as ars
from brax_torch.training.agents.es import train as es
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.training.agents.sac import train as sac
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2 import io as v2_io
from brax_torch.v2.base import map_tensors


# the settings of a braxlines PPO recipe that the CLI takes as flags (the
# rest are the CLI's defaults, equal to the recipes': normalize_observations,
# seed 0)
RECIPE_FLAGS = ("num_envs", "batch_size", "num_minibatches", "num_updates_per_batch",
                "unroll_length", "learning_rate", "entropy_cost", "discounting",
                "reward_scaling", "episode_length", "action_repeat")


def recipe_argv(recipe: dict, env: str, training_steps: int, *extra: str) -> List[str]:
    """`main`'s arguments for PPO on `env` at a braxlines recipe
    (`braxlines.defaults.DEFAULT_PPO_PARAMS`) for `training_steps` training
    steps, followed by `extra`."""
    per_step = (recipe["batch_size"] * recipe["unroll_length"] * recipe["num_minibatches"]
                * recipe["action_repeat"])
    argv = ["--learner", "ppo", "--env", env, "--total_env_steps", str(training_steps * per_step)]
    for flag in RECIPE_FLAGS:
        argv += [f"--{flag}", str(recipe[flag])]
    return argv + list(extra)


def rollout(env, policy, generator: torch.Generator, max_steps: int, frame,
            until_done: bool = True) -> list:
    """`frame(state)` of each state of one episode of `policy` in `env` (batch
    1, `auto_reset=False`) from `env.reset(generator)`: up to `max_steps`
    frames, ending at the first done unless `until_done` is False.  On CUDA
    the policy runs on the fused MLP kernels, as the trainers' networks do."""
    frames = []
    with fused_mlp.enabled_as(generator.device.type == "cuda"), torch.no_grad():
        state = env.reset(generator)
        while len(frames) < max_steps and not (until_done and bool(state.done[0])):
            frames.append(frame(state))
            state = env.step(state, policy(state.obs, generator)[0])
    return frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="brax_torch RL training")
    p.add_argument("--learner", default="ppo", choices=["ppo", "apg", "es", "sac", "ars"])
    p.add_argument("--env", default="ant")
    p.add_argument("--engine", default="v1", choices=["v1", "v2"],
                   help="v1: maximal-coordinate PBD engine (brax_torch.envs); "
                        "v2: generalized-coordinate engine (brax_torch.v2.envs)")
    p.add_argument("--backend", default="generalized",
                   choices=["generalized", "spring", "positional"],
                   help="v2 physics backend (--engine v2 only; the port has generalized)")
    p.add_argument("--total_env_steps", type=int, default=50_000_000)
    p.add_argument("--num_evals", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_envs", type=int, default=4)
    p.add_argument("--action_repeat", type=int, default=1)
    p.add_argument("--unroll_length", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_minibatches", type=int, default=1)
    p.add_argument("--num_updates_per_batch", type=int, default=1)
    p.add_argument("--reward_scaling", type=float, default=10.0)
    p.add_argument("--entropy_cost", type=float, default=3e-4)
    p.add_argument("--episode_length", type=int, default=1000)
    p.add_argument("--discounting", type=float, default=0.99)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--max_gradient_norm", type=float, default=1e9)
    p.add_argument("--logdir", default="/tmp/brax_tpu_learner")
    p.add_argument("--normalize_observations", action="store_true", default=True)
    p.add_argument("--aot_cache", action="store_true", default=False,
                   help="build and load every CUDA library of the run before it starts "
                        "(brax_torch/aot.py) and print the seconds")
    p.add_argument("--no_normalize_observations", dest="normalize_observations",
                   action="store_false")
    p.add_argument("--num_videos", type=int, default=1)
    p.add_argument("--num_trajectories_npy", type=int, default=0)
    # ES
    p.add_argument("--population_size", type=int, default=1)
    p.add_argument("--perturbation_std", type=float, default=0.1)
    p.add_argument("--fitness_shaping", default="original",
                   choices=["original", "centered_rank", "wierstra"])
    p.add_argument("--center_fitness", action="store_true")
    p.add_argument("--l2coeff", type=float, default=0.0)
    # SAC
    p.add_argument("--min_replay_size", type=int, default=8192)
    p.add_argument("--max_replay_size", type=int, default=1048576)
    p.add_argument("--grad_updates_per_step", type=int, default=1)
    # PPO
    p.add_argument("--gae_lambda", type=float, default=0.95)
    p.add_argument("--clipping_epsilon", type=float, default=0.3)
    # ARS
    p.add_argument("--number_of_directions", type=int, default=60)
    p.add_argument("--top_directions", type=int, default=20)
    p.add_argument("--exploration_noise_std", type=float, default=0.1)
    p.add_argument("--reward_shift", type=float, default=0.0)
    # APG
    p.add_argument("--truncation_length", type=int, default=None)
    # sweeps (braxlines experiment infra)
    p.add_argument("--sweep", default=None,
                   help="a named braxlines sweep (not ported yet: ROADMAP queue A item 8)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda: the port's kernels; cpu: their plain "
                        "versions)")
    return p


def train(args: argparse.Namespace, environment, progress_fn):
    """Runs `args.learner`; returns (make_policy, params, metrics)."""
    common = dict(environment=environment, action_repeat=args.action_repeat,
                  normalize_observations=args.normalize_observations, num_evals=args.num_evals,
                  seed=args.seed, episode_length=args.episode_length, progress_fn=progress_fn,
                  device=args.device)
    if args.learner == "sac":
        return sac.train(
            num_envs=args.num_envs, num_timesteps=args.total_env_steps,
            batch_size=args.batch_size, min_replay_size=args.min_replay_size,
            max_replay_size=args.max_replay_size, learning_rate=args.learning_rate,
            discounting=args.discounting, reward_scaling=args.reward_scaling,
            grad_updates_per_step=args.grad_updates_per_step, **common)
    if args.learner == "es":
        return es.train(
            num_timesteps=args.total_env_steps,
            fitness_shaping=es.FitnessShaping[args.fitness_shaping.upper()],
            population_size=args.population_size, perturbation_std=args.perturbation_std,
            center_fitness=args.center_fitness, l2coeff=args.l2coeff,
            learning_rate=args.learning_rate, **common)
    if args.learner == "ppo":
        return ppo.train(
            num_timesteps=args.total_env_steps, num_envs=args.num_envs,
            learning_rate=args.learning_rate, entropy_cost=args.entropy_cost,
            discounting=args.discounting, unroll_length=args.unroll_length,
            batch_size=args.batch_size, num_minibatches=args.num_minibatches,
            num_updates_per_batch=args.num_updates_per_batch,
            reward_scaling=args.reward_scaling, gae_lambda=args.gae_lambda,
            clipping_epsilon=args.clipping_epsilon, **common)
    if args.learner == "apg":
        return apg.train(
            num_envs=args.num_envs, learning_rate=args.learning_rate,
            max_gradient_norm=args.max_gradient_norm,
            truncation_length=args.truncation_length, **common)
    return ars.train(
        number_of_directions=args.number_of_directions, num_timesteps=args.total_env_steps,
        exploration_noise_std=args.exploration_noise_std, step_size=args.learning_rate,
        top_directions=args.top_directions, reward_shift=args.reward_shift, **common)


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.sweep:
        raise NotImplementedError(
            f"--sweep {args.sweep}: braxlines' experiments.py and sweeps.py are not ported yet "
            "(ROADMAP queue A item 8)")
    device = torch.device(args.device)
    built = None
    if args.aot_cache:
        built = aot.prebuild(args.env, args.engine, args.backend, device=device)
        print(f"aot_cache: built {built['built']} and loaded {built['libraries']} in "
              f"{built['seconds']:.1f} s", flush=True)

    if args.engine == "v2":
        def environment(batch_size, device):
            return v2_envs.get_environment(args.env, backend=args.backend,
                                           batch_size=batch_size, device=device)
    else:
        environment = args.env
    with metrics.Writer(args.logdir) as writer:
        writer.write_hparams({"num_evals": args.num_evals, "num_envs": args.num_envs,
                              "total_env_steps": args.total_env_steps})
        make_policy, params, _ = train(args, environment, writer.write_scalars)
    out = {"events": writer.path, "videos": [], "trajectories": [], "rollout_steps": [],
           "aot": built, "make_policy": make_policy, "policy_params": params}

    out["params"] = os.path.join(args.logdir, f"{args.env}_{args.learner}.pkl")
    model.save_params(out["params"], params)
    print(f"saved params to {out['params']}")

    # post-training rollouts for videos / trajectory dumps
    n_rollouts = max(args.num_videos, args.num_trajectories_npy)
    if n_rollouts == 0:
        return out
    if args.engine == "v2":
        env = v2_envs.create(args.env, backend=args.backend, episode_length=args.episode_length,
                             auto_reset=False, batch_size=1, device=device)
        frame = lambda state: map_tensors(lambda x: x[0], state.pipeline_state)
    else:
        env = envs.create(args.env, auto_reset=False, batch_size=1, device=device)
        frame = lambda state: map_tensors(lambda x: x[0], state.qp)
    policy = make_policy(params)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    trajectories = [rollout(env, policy, generator, args.episode_length, frame)
                    for _ in range(n_rollouts)]
    out["rollout_steps"] = [len(frames) for frames in trajectories]

    for i in range(args.num_videos):
        path = f"{args.logdir}/saved_videos/trajectory_{i:04d}.html"
        if args.engine == "v2":
            v2_io.save_html(path, env.unwrapped.sys, trajectories[i])
        elif hasattr(env.unwrapped, "art"):
            html.save_html(path, env.unwrapped.art.config, trajectories[i])
        else:
            continue
        out["videos"].append(path)
        print(f"saved {path}")
    if args.engine == "v1":
        for i in range(args.num_trajectories_npy):
            path = f"{args.logdir}/saved_qps/trajectory_{i:04d}.npy"
            npy_file.save(path, trajectories[i])
            out["trajectories"].append(path)
            print(f"saved {path}")
    return out


if __name__ == "__main__":
    main()

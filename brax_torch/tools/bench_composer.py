"""The contact-heavy multi-agent composer scene's env.step throughput on
the card.

Counterpart of `tools/bench_composer.py`: builds an N-agent chase scene
(`composer.envs.create_ma_env("chase", num_agents=N)`: the ants on a
circle, every pair of agents colliding, the wide PBD route for its 170
contact points at 4 agents) at a large batch and times `env.step` with
uniform random actions: one rollout to warm, then 3 rollouts of `steps`
steps, host clock around them (after a synchronize).  Checks one PBD
launch per step and finite observations, and prints one RESULT line.

    python -m brax_torch.tools.bench_composer [batch=16384] [steps=50] [num_agents=4]
"""

from __future__ import annotations

import json
import sys
import time

import torch

from brax_torch import cuda_build
from brax_torch.composer import envs as composer_envs
from brax_torch.sim import kernels

ITERS = 3


def main(argv):
    batch = int(argv[0]) if len(argv) > 0 else 16384
    steps = int(argv[1]) if len(argv) > 1 else 50
    num_agents = int(argv[2]) if len(argv) > 2 else 4
    card = cuda_build.card()
    print(card, flush=True)
    env = composer_envs.create_ma_env(task="chase", episode_length=1000, batch_size=batch,
                                      auto_reset=True, num_agents=num_agents, device="cuda")
    p = kernels.plan(env.sys)
    print(f"scene: {num_agents}-agent chase, action_size={env.action_size}, "
          f"obs={env.observation_size}, batch={batch}; {p.nb} bodies, {p.nj} joints, "
          f"{p.nc} contact points, {p.lanes} lanes an env, {p.threads} threads a block",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    state = env.reset(gen)
    torch.cuda.synchronize()
    print(f"reset (the kernel built at first use by the step): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    def rollout(state):
        for _ in range(steps):
            act = torch.rand((batch, env.action_size), generator=gen, device="cuda") * 2 - 1
            state = env.step(state, act)
        return state

    t0 = time.perf_counter()
    state = rollout(state)
    torch.cuda.synchronize()
    print(f"first rollout (build included): {time.perf_counter() - t0:.1f}s", flush=True)
    kernels.pbd_step_launch.launches = 0
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state = rollout(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.pbd_step_launch.launches
    if launches != ITERS * steps:
        raise AssertionError(f"{launches} pbd_step launches over {ITERS * steps} steps")
    if not bool(torch.isfinite(state.obs).all()):
        raise AssertionError("non-finite observations")
    sps = batch * steps * ITERS / dt
    print(f"{ITERS} x {steps} steps in {dt:.3f} s: {sps:,.0f} env-steps/s, "
          f"{dt / (ITERS * steps) * 1e3:.3f} ms a step [{card}]", flush=True)
    print("RESULT " + json.dumps({
        "metric": f"composer_chase{num_agents}_env_steps_per_s",
        "value": round(sps),
        "batch": batch,
        "unit": "env-steps/s",
        "ms_per_step": dt / (ITERS * steps) * 1e3,
        "pbd_step_launches": launches,
        "card": card,
    }))


if __name__ == "__main__":
    main(sys.argv[1:])

"""The v2 generalized kernel's rollout paths on the card: `env.step` and
the chain entry, in turns.

Counterpart of `tools/bench_v2_generalized.py`'s path (its `env.step` and
`build_tiled_chain_fn` rollouts).  For each env it

1. holds one generalized frame of the kernel (`gen_step`, one frame)
   against `pipeline.step` from the env's reset with zero actions, and
   prints each env's |dq| and |dqd| (median, p99, max), as the JAX tool
   prints its fused-vs-XLA distribution;
2. times `steps` chained `env.step` calls of the bare env (zero actions,
   host clock after a synchronize) and `steps` chained steps of
   `kernels.build_tiled_chain_fn` (the physics alone, its carry kept in the
   kernel's (fields, N) layout: one launch a step, no transposes), issued
   by the host and replayed from a CUDA graph (the counterpart of the JAX
   tool's jitted `lax.scan`), in turns: env, chain, graph, graph, chain,
   env;
3. prints a `RESULT {...}` line per env: env-steps/s of each path (each
   turn's), the card and the parity figures.

    python -m brax_torch.tools.bench_v2_generalized [batch=4096] [steps=50] [env ...]

Without env names it runs v2 ant and the six other ported v2 envs.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from brax_torch import cuda_build
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels, pipeline

ENVS = ("ant", "inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah",
        "hopper", "walker2d")


def _soa(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).t().contiguous()


def one_frame_parity(env, state, act) -> dict:
    """Per-env max |kernel - pipeline.step| of q and qd over one frame:
    {name: {median, p99, max}}."""
    ps = state.pipeline_state
    got = kernels.gen_step(env.sys, ps.q, ps.qd, ps.mass_mx_inv, act, 1)
    want = pipeline.step(env.sys, ps, act)
    out = {}
    for name in ("q", "qd"):
        d = (got[name] - getattr(want, name)).abs().amax(dim=1)
        out[name] = {"median": float(d.median()), "p99": float(torch.quantile(d, 0.99)),
                     "max": float(d.max())}
    return out


def chain_runner(env, state, act, steps: int):
    """(host, graph): two callables that each run `steps` chained chain
    steps from the state's carry, issued by the host and replayed from a
    CUDA graph captured once here."""
    n = act.shape[0]
    step_t, _ = kernels.build_tiled_chain_fn(env.sys, env._n_frames, n)
    ps = state.pipeline_state
    carry0 = (_soa(ps.q), _soa(ps.qd), _soa(ps.mass_mx_inv))
    act_t = _soa(act)

    def host():
        c = carry0
        for _ in range(steps):
            c, _ = step_t(c, act_t)
        return c

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        host()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        host()
    return host, graph.replay


def env_runner(env, state, act, steps: int):
    def run():
        s = state
        for _ in range(steps):
            s = env.step(s, act)
        return s
    return run


def timed(fn, env_steps: int) -> float:
    """env-steps/s of fn(), host clock around a synchronized call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return env_steps / (time.perf_counter() - t0)


def measure(name: str, batch: int = 4096, steps: int = 50, device="cuda") -> dict:
    """The parity and the turns for one v2 env; also counts the chain's
    launches over one host-issued rollout (exactly `steps`)."""
    env = v2_envs.get_environment(name, batch_size=batch, device=device)
    state = env.reset(torch.Generator(device=device).manual_seed(0))
    act = torch.zeros((batch, env.action_size), device=device)
    parity = one_frame_parity(env, state, act)
    run_env = env_runner(env, state, act, steps)
    chain_host, chain_graph = chain_runner(env, state, act, steps)
    run_env()  # warm
    before = kernels.gen_step_soa.launches
    chain_host()
    launches = kernels.gen_step_soa.launches - before
    if launches != steps:
        raise AssertionError(f"{name}: the chain launched {launches} times over {steps} steps")
    turns = {"env.step": [], "chain host-issued": [], "chain graph-replayed": []}
    for kind in ("env.step", "chain host-issued", "chain graph-replayed",
                 "chain graph-replayed", "chain host-issued", "env.step"):
        fn = {"env.step": run_env, "chain host-issued": chain_host,
              "chain graph-replayed": chain_graph}[kind]
        turns[kind].append(timed(fn, batch * steps))
    return {"env": name, "batch": batch, "steps": steps, "n_frames": env._n_frames,
            "one_frame_parity": parity, "chain_launches": launches,
            "env_steps_per_s": turns}


def main(argv):
    batch = int(argv[0]) if len(argv) > 0 else 4096
    steps = int(argv[1]) if len(argv) > 1 else 50
    names = tuple(argv[2:]) or ENVS
    card = cuda_build.card()
    print(card, flush=True)
    for name in names:
        r = measure(name, batch, steps)
        for field, d in r["one_frame_parity"].items():
            print(f"{name}: kernel vs pipeline.step, one frame, per-env |d{field}|: median "
                  f"{d['median']:.2e} p99 {d['p99']:.2e} max {d['max']:.2e}", flush=True)
        for kind, rates in r["env_steps_per_s"].items():
            print(f"{name}: {kind}: {', '.join(f'{x:,.0f}' for x in rates)} env-steps/s "
                  f"({batch} envs, {steps} steps, in turns) [{card}]", flush=True)
        print("RESULT " + json.dumps({**r, "card": card}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

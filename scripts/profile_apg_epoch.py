"""One APG epoch of the v1 ant on the card, timed, and a short one profiled.

    python scripts/profile_apg_epoch.py [--envs 2048] [--episode 1000] [--profile-steps 3]

1. `apg.train("ant")` at `--envs` envs for one epoch of `--episode` steps
   and one evaluation of 128 envs (the learner CLI's learning rate and
   clip, observations normalised), unprofiled: the epoch's rollout,
   backward and update seconds (host clock around synchronised phases),
   the twin's runs in the backward (`kernels.PBDStep.backward_calls`), the
   PBD and fused-MLP launches, and the peak device memory
   (`torch.cuda.max_memory_allocated`);
2. the same at `--profile-steps` steps under `torch.profiler`: each range's
   host time ("apg/rollout", "apg/backward", "apg/update"), the device time
   of the kernels that started inside it and its busy share, and the
   kernels per twin run in the backward.  A 1000-step epoch issues tens of
   millions of device ops, more than the profiler can hold, so the trace
   covers a short epoch of the same batch.

Prints the card's name and power limit first and a `{"apg_epoch": ...}`
JSON line last.  Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from brax_torch import cuda_build  # noqa: E402
from brax_torch.sim import kernels  # noqa: E402
from brax_torch.training import fused_mlp  # noqa: E402
from brax_torch.training.agents.apg import train as apg  # noqa: E402

# the learner CLI's defaults (brax_tpu/training/learner.py:47-48)
RECIPE = dict(learning_rate=5e-4, max_gradient_norm=1e9, normalize_observations=True,
              num_eval_envs=128, num_evals=1)


def counts():
    return {"pbd_step": kernels.pbd_step_launch.launches,
            "fused_mlp_fwd": fused_mlp.chain_fwd.launches,
            "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
            "twin_backward_runs": kernels.PBDStep.backward_calls}


def epoch(envs, steps):
    """One epoch and its evaluation: (metrics, the counts it added, wall s)."""
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = apg.train("ant", episode_length=steps, num_envs=envs, device="cuda", **RECIPE)[2]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return metrics, {k: v - before[k] for k, v in counts().items()}, wall


def profiled(envs, steps):
    """Host ms, device ms and busy share of each range of a profiled epoch."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(envs, steps)
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kernels_ = [e for e in events if e.device_type == cuda
                and not getattr(e, "is_user_annotation", False) and "/" not in e.name
                and "#" not in e.name]
    out = {}
    for name in ("apg/rollout", "apg/backward", "apg/update"):
        spans = [e for e in events if e.name == name and e.device_type == cpu]
        if not spans:
            continue
        t0, t1 = spans[-1].time_range.start, spans[-1].time_range.end
        inside = [e for e in kernels_ if t0 <= e.time_range.start <= t1]
        device_us = sum(e.time_range.elapsed_us() for e in inside)
        out[name.split("/")[1]] = {"host_ms": (t1 - t0) / 1e3, "device_ms": device_us / 1e3,
                                   "busy": device_us / max(t1 - t0, 1), "device_ops": len(inside)}
    twin_runs = sum(1 for e in events
                    if e.name == "pbd_step/twin_backward" and e.device_type == cpu)
    if "backward" in out and twin_runs:
        out["backward"]["device_ops_per_twin_run"] = out["backward"]["device_ops"] / twin_runs
    out["twin_runs"] = twin_runs
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--envs", type=int, default=2048)
    parser.add_argument("--episode", type=int, default=1000)
    parser.add_argument("--profile-steps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_apg_epoch.py needs a CUDA device; torch.cuda.is_available() is False")
    card = cuda_build.card()
    print(card, flush=True)
    # build the kernels and warm the caches on a short epoch first
    epoch(args.envs, args.profile_steps)
    torch.cuda.reset_peak_memory_stats()
    metrics, launched, wall = epoch(args.envs, args.episode)
    peak = torch.cuda.max_memory_allocated()
    record = {
        "envs": args.envs, "episode": args.episode, "wall_s": wall,
        **{k: metrics[f"training/{k}"] for k in ("rollout_s", "backward_s", "update_s",
                                                 "grad_norm", "unclipped_grad_norm",
                                                 "params_norm", "sps")},
        "eval_episode_reward": metrics["eval/episode_reward"],
        "launches": launched, "peak_memory_bytes": peak, "card": card,
    }
    print(f"epoch [{card}]: {args.episode} steps of {args.envs} ants: rollout "
          f"{record['rollout_s'] * 1e3:.1f} ms, backward {record['backward_s'] * 1e3:.1f} ms, "
          f"update {record['update_s'] * 1e3:.2f} ms; gradient norm {record['grad_norm']:.5g} "
          f"({record['unclipped_grad_norm']:.5g} before the clip); launches {launched}; peak "
          f"memory {peak / 2**30:.3f} GiB", flush=True)
    record["profile"] = profiled(args.envs, args.profile_steps)
    record["profile_steps"] = args.profile_steps
    print(f"profile [{card}]: {args.profile_steps}-step epoch: {record['profile']}")
    print(json.dumps({"apg_epoch": record}))


if __name__ == "__main__":
    main()

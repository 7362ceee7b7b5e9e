"""PPO ant's time to reward on one device.

    python -m brax_torch.tools.time_to_solve [--threshold 6000] [--num_timesteps 20000000]
        [--num_evals 40] [--env ant] [--device cuda]

Counterpart of the root `tools/time_to_solve.py`: trains `--env` with
PPO at its published recipe (`braxlines.defaults.get_ppo_params`; ant's
for an env without one) for `--num_timesteps` env steps with
`--num_evals` evaluations (seed 0), prints each evaluation as it comes
(step, eval reward, seconds since the first training step), then one `CURVE {...}` JSON line (the whole curve)
and, last, one `RESULT {...}` JSON line: the threshold, whether an eval
reward reached it (`solved`), the env step and the wall-clock of the first
eval that did (`solve_steps`, `solve_walltime_s`, from the first training
step, the evaluations between included; `solve_training_walltime_s`, the
training steps' own seconds), the final eval reward, the set-up seconds
before the first training step (env and kernel builds, the step-0
evaluation) and the card (`cuda_build.card()`; "cpu" on the CPU).

The JAX tool's accelerator-only fields (device hand-off, compile cache,
ahead-of-time cache) have no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

from brax_torch import cuda_build
from brax_torch.braxlines.defaults import get_ppo_params
from brax_torch.training.agents.ppo import train as ppo


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threshold", type=float, default=6000.0)
    parser.add_argument("--num_timesteps", type=int, default=20_000_000)
    parser.add_argument("--num_evals", type=int, default=40)
    parser.add_argument("--env", default="ant")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, **overrides) -> dict:
    """Runs the tool; `overrides` replace ppo.train's arguments (the CPU
    test cuts the recipe's widths with them).  Returns the RESULT record."""
    args = parse_args(argv)
    cfg = dict(get_ppo_params(args.env, num_timesteps=args.num_timesteps),
               num_evals=args.num_evals, device=args.device)
    cfg.update(overrides)
    card = cuda_build.card() if args.device.startswith("cuda") else "cpu"
    print(f"ppo {args.env} to reward >= {args.threshold} on {card}: "
          f"{json.dumps({k: v for k, v in cfg.items() if k != 'device'})}", flush=True)

    start = time.time()
    clock = {}
    events = []

    def progress(step, metrics):
        now = time.time()
        # the step-0 evaluation runs before the first training step
        if step == 0 and not events:
            clock["first_training_step"] = now
        t0 = clock.setdefault("first_training_step", start)
        reward = float(metrics.get("eval/episode_reward", float("nan")))
        events.append({"step": int(step), "reward": reward, "seconds": now - t0,
                       "training_walltime_s": float(metrics.get("training/walltime", 0.0))})
        print(f"  step {step}: reward {reward:.1f} ({now - t0:.1f} s)", flush=True)

    ppo.train(args.env, progress_fn=progress, **cfg)

    solve = next((e for e in events if e["reward"] >= args.threshold), None)
    print("CURVE " + json.dumps({"env": args.env, "card": card,
                                 "curve": [[e["step"], e["reward"], e["seconds"]]
                                           for e in events]}))
    out = {
        "threshold": args.threshold,
        "solved": solve is not None,
        "solve_steps": solve["step"] if solve else None,
        "solve_walltime_s": solve["seconds"] if solve else None,
        "solve_training_walltime_s": solve["training_walltime_s"] if solve else None,
        "final_reward": events[-1]["reward"] if events else None,
        "setup_s": clock.get("first_training_step", start) - start,
        "num_timesteps": cfg["num_timesteps"],
        "env": args.env,
        "card": card,
    }
    print("RESULT " + json.dumps(out))
    return out


if __name__ == "__main__":
    main()

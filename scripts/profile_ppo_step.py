"""Profiles one PPO training step of a v1 env at its published recipe, on
the card.

    python scripts/profile_ppo_step.py reacher    # or grasp, fetch

Runs chip_smoke.py's `profile_training_step` (two training steps at
DEFAULT_PPO_PARAMS[name], the fused MLP kernels on, the episode cut to
PROFILE_EPISODE steps) and prints its record: the second step's host time,
its rollout and SGD ranges, the device's busy time and share, and the top
kernels and host ops, beside the card's name and power limit.
chip_smoke.py profiles ant's training step itself; reacher's step makes
~137k device ops (800 PBD launches, four physics steps to an env step),
whose trace the profiler takes minutes to process, so it runs here, apart
from chip_smoke.py's time limit, as do grasp's (80 PBD launches, 64
minibatch steps) and fetch's (80 PBD launches, 128 minibatch steps).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from brax_torch import cuda_build  # noqa: E402

if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_ppo_step.py needs a CUDA device; torch.cuda.is_available() is False")
    name = sys.argv[1]
    card = cuda_build.card()
    print(card)
    prof = chip_smoke.profile_training_step(True, environment=name, preset=name)
    chip_smoke.print_profile(f"[{card}]", f"{name} ", "on", prof)

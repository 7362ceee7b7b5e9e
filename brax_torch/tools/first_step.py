"""PPO ant's first training step through the learner CLI, cold or warm.

    python -m brax_torch.tools.first_step [--aot_cache] [--device cuda]

Runs `python -m brax_torch.training.learner` in this process at the ant
recipe (`braxlines.defaults`, full width) for one training step, one
evaluation and no rollout, and prints the card's name and power limit and
a last line `RESULT {...}`: whether the run was cold (none of its CUDA
libraries built before it: `aot.libraries`, `cuda_build.library_path`),
`aot_cache`, the prebuild's seconds and the sources it compiled (with
`--aot_cache`), the first training step's seconds (`training/walltime` of
the run's one epoch: with no prebuild it includes the builds and loads at
first use), the evaluation's seconds, the seconds of `main` and of the
whole process from this module's import.  Run it twice for a cold and a
warm number: the second run finds the first's builds.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import List, Optional

_IMPORTED = time.perf_counter()

from brax_torch import aot, cuda_build  # noqa: E402
from brax_torch.braxlines.defaults import DEFAULT_PPO_PARAMS  # noqa: E402
from brax_torch.io import metrics  # noqa: E402
from brax_torch.training import learner  # noqa: E402


def main(args: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--aot_cache", action="store_true")
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args(args)
    card = cuda_build.card() if opts.device.startswith("cuda") else "cpu"
    print(card, flush=True)
    libs = aot.libraries("ant", device=opts.device)
    cold = not any(cuda_build.library_path(lib.source).exists() for lib in libs.values())
    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        out = learner.main(learner.recipe_argv(
            DEFAULT_PPO_PARAMS["ant"], "ant", 1, "--num_evals", "1", "--num_videos", "0",
            "--logdir", logdir, "--device", opts.device, *(["--aot_cache"] * opts.aot_cache)))
        main_s = time.perf_counter() - t0
        scalars = {tag: value for tag, _, value in metrics.read_scalars(out["events"])}
    result = {
        "cold": cold, "aot_cache": opts.aot_cache,
        "prebuild_s": out["aot"]["seconds"] if out["aot"] else None,
        "built": out["aot"]["built"] if out["aot"] else None,
        "first_training_step_s": scalars["training/walltime"],
        "eval_s": scalars["eval/epoch_eval_time"], "main_s": main_s,
        "process_s": time.perf_counter() - _IMPORTED, "card": card,
    }
    print("RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()

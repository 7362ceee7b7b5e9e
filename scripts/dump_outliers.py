"""Saves, on the card, the inputs of the envs where the PBD kernel leaves
the tolerance of its twin over one pass, with both outputs, for
scripts/replay_outliers.py.

    python scripts/dump_outliers.py OUT.npz

The state is chip_smoke.py's v1 halfcheetah state after 10 twin steps at
4096 envs, made with its seeds (`capcap_paths`: the reset and the ten
actions from one generator seeded 0, then the reset's action and this
state's), and the step one PBD pass (`pbd_parity.one_pass`), where that
state is held by the chaos rule (`pbd_parity.RULES`).  Saved: the indices
of the envs outside `pbd_parity.TOLERANCE` in some field, their pos, rot,
vel, ang and action, and the kernel's and the twin's six outputs there.
Prints each such env's errors, the chaos rule's reading, and the card's
name and power limit.  Imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brax_torch import cuda_build, envs  # noqa: E402
from brax_torch.sim import kernels  # noqa: E402
from brax_torch.tools import pbd_parity as pp  # noqa: E402

N = 4096


def main(out_path):
    if not torch.cuda.is_available():
        sys.exit("dump_outliers.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    print(cuda_build.card())
    env = envs.create("halfcheetah", episode_length=1000, batch_size=N)
    gen = torch.Generator(device=device).manual_seed(0)
    rand_act = lambda: torch.rand((N, env.action_size), generator=gen, device=device) * 2 - 1
    qp = env.reset(gen).qp
    for _ in range(10):
        qp, _ = kernels.pbd_step_plain(env.sys, qp, rand_act())
    rand_act()  # the reset state's action
    act = rand_act()
    sys_ = pp.one_pass(env.sys)
    out, info = kernels.pbd_step(sys_, qp, act)
    got = pp.fields(out, info)
    want = pp.fields(*kernels.pbd_step_plain(sys_, qp, act))
    errs = pp.per_env_errors(got, want)
    over = torch.stack([errs[k] > pp.TOLERANCE[k] for k in pp.TOLERANCE]).any(dim=0)
    idx = over.nonzero().flatten()
    for i in idx.tolist():
        print(f"env {i}: " + ", ".join(f"{k} {float(errs[k][i]):.3e}" for k in pp.TOLERANCE))
    report, strays, allowed = pp.chaos_rule(sys_, qp, act, got, want)
    print(f"chaos rule: {len(strays)} envs stray ({strays.tolist()[:16]}), at most {allowed} may")
    host = lambda x: x[idx].cpu().numpy()
    np.savez(out_path, index=idx.cpu().numpy(), pos=host(qp.pos), rot=host(qp.rot),
             vel=host(qp.vel), ang=host(qp.ang), act=host(act),
             **{f"kernel_{k}": host(v) for k, v in got.items()},
             **{f"twin_{k}": host(v) for k, v in want.items()})
    print(f"saved {len(idx)} envs to {out_path}")
    print(cuda_build.card())


if __name__ == "__main__":
    main(sys.argv[1])

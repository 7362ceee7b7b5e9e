"""The v2 generalized ant's long zero-action rollouts, in the port's plain
route and the JAX package's jnp pipeline, on the CPU.

    JAX_PLATFORMS=cpu python scripts/v2_blowups_vs_jax.py [envs=2048] [steps=50]

Resets `envs` v2 ants (`brax_torch.v2.envs`, seed 6) and steps them
`steps` env steps of 5 frames with zero actions and no reset, through
`gen_step_plain` (the kernel's plain version, bit-identical to the kernel
on the card); an env blows up where its qd leaves 1e3 or turns non-finite.
The blown envs' reset states then go through the JAX package's generalized
pipeline (`pipeline.init`, then 5 `pipeline.step` frames an env step,
jitted), the reference the port follows: prints, per step, how many of
them blow up there too.  chip_smoke.py's chain main path reads the same
rollout on the card (its non-finite envs).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels


def blown(qd) -> np.ndarray:
    qd = np.asarray(qd)
    return ~np.isfinite(qd).all(axis=1) | (np.abs(np.nan_to_num(qd, nan=np.inf)).max(axis=1) > 1e3)


def main(argv):
    n = int(argv[0]) if argv else 2048
    steps = int(argv[1]) if len(argv) > 1 else 50
    env = v2_envs.create("ant", batch_size=n, device="cpu")
    ps = env.reset(torch.Generator().manual_seed(6)).pipeline_state
    q0, qd0 = ps.q.numpy().copy(), ps.qd.numpy().copy()
    q, qd, minv = ps.q, ps.qd, ps.mass_mx_inv
    zero = torch.zeros(n, 8)
    first = {}
    t0 = time.perf_counter()
    for i in range(steps):
        out = gen_kernels.gen_step_plain(env.sys, q, qd, minv, zero, 5)
        q, qd, minv = out["q"], out["qd"], out["minv"]
        for b in np.flatnonzero(blown(qd.numpy())):
            first.setdefault(int(b), i)
    idx = sorted(first)
    print(f"port plain route: {len(idx)} of {n} envs blew up within {steps} steps "
          f"({time.perf_counter() - t0:.0f} s): {[(b, first[b]) for b in idx]}", flush=True)
    if not idx:
        return
    from brax_tpu.v2.envs import ant as jax_ant
    from brax_tpu.v2.generalized import pipeline

    sys_ = jax_ant.Ant(backend="generalized").sys
    init = jax.jit(jax.vmap(lambda q_, qd_: pipeline.init(sys_, q_, qd_)))

    def frames(s, a):
        return jax.lax.scan(lambda c, _: (pipeline.step(sys_, c, a), None), s, (), 5)[0]

    step = jax.jit(jax.vmap(frames))
    s = init(jnp.asarray(q0[idx]), jnp.asarray(qd0[idx]))
    a = jnp.zeros((len(idx), 8))
    seen = np.zeros(len(idx), dtype=bool)
    for i in range(steps):
        s = step(s, a)
        seen |= blown(s.qd)
        print(f"step {i}: the JAX pipeline has blown up in {int(seen.sum())} of these "
              f"{len(idx)} envs", flush=True)
    print(f"RESULT {{\"envs\": {n}, \"steps\": {steps}, \"port_blown\": {len(idx)}, "
          f"\"jax_blown_of_those\": {int(seen.sum())}}}")


if __name__ == "__main__":
    main(sys.argv[1:])

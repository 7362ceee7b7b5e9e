"""Replays the card's PBD parity outliers through the twin in float64 and
both JAX paths on the CPU.

    JAX_PLATFORMS=cpu python scripts/replay_outliers.py FILE.npz [ant|halfcheetah]

FILE.npz holds the inputs of the envs where the CUDA kernel and its
plain-torch twin disagree beyond tolerance, with both outputs:
`pbd_parity.max_errors` saves ant's (the whole step) to
build/brax_torch/parity_outliers.npz; scripts/dump_outliers.py saves
halfcheetah's over one pass (its first argument).  The same inputs go
through the twin in float64 (every table and state widened, the default
dtype float64: the reference the float32 paths round around), the twin in
float32, the JAX jnp step (`brax_tpu.sim.system._raw_step`, traced in the
JAX package's kernel mode, whose arctan2 is the kernel's polynomial) and
the JAX Pallas kernel's math (`brax_tpu.sim.kernels._build_tile_step`,
eager).  Each float32 path is also run on COPIES copies of each env's
input with relative noise NOISE (about one float32 ulp): its float32
spread, the farthest a copy lands from the float64 result.  Printed per
env and field: each path's distance to the float64 result and each JAX
path's spread, the CUDA kernel's distance, and whether the kernel lies
inside the spread of either JAX path.  A kernel outside the spread of
both is off by more than float32 rounding of the same arithmetic.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brax_tpu.sim import kernels as jax_kernels  # noqa: E402
from brax_tpu.sim import lowering  # noqa: E402
from brax_tpu.sim import system as jax_system  # noqa: E402
from brax_torch.sim import kernels  # noqa: E402
from brax_torch.sim.types import QP  # noqa: E402
from brax_torch.tools import pbd_parity as pp  # noqa: E402

FIELDS = ("pos", "rot", "vel", "ang", "contact_vel", "contact_ang")
COPIES = 8
NOISE = 1e-7


def scene(name):
    """(port System, JAX System, whether the dump holds one pass: all six
    outputs) of the dump's scene."""
    if name == "ant":
        from brax_torch.envs.ant import Ant
        from brax_tpu.envs.ant import Ant as JaxAnt

        port, ref = Ant(use_contact_forces=True, device="cpu").sys, JaxAnt().sys
        return port, ref, False
    from brax_torch.envs.halfcheetah import Halfcheetah
    from brax_tpu.envs.halfcheetah import Halfcheetah as JaxHalfcheetah

    port, ref = Halfcheetah(device="cpu").sys, JaxHalfcheetah().sys
    return pp.one_pass(port), ref.replace(substeps=2), True


def widened(obj):
    """A copy of a System (dataclasses, tuples, tensors) in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: widened(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(widened(x) for x in obj)
    if isinstance(obj, list):
        return [widened(x) for x in obj]
    return obj


def twin(sys_, ins, dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        qp = QP(*(torch.from_numpy(x).to(dtype) for x in ins[:4]))
        out, info = kernels.pbd_step_plain(sys_, qp, torch.from_numpy(ins[4]).to(dtype))
    finally:
        torch.set_default_dtype(prev)
    return [x.double().numpy() for x in (out.pos, out.rot, out.vel, out.ang, info.contact.vel,
                                         info.contact.ang)]


def main(path, name="ant"):
    d = np.load(path)
    port, ref, one_pass = scene(name)
    ins = [d[k] for k in ("pos", "rot", "vel", "ang", "act")]
    n = ins[0].shape[0]
    index = d["index"] if "index" in d.files else np.arange(n)
    f64 = twin(widened(port), ins, torch.float64)
    step = jax.jit(jax.vmap(lambda qp, act: jax_system._raw_step(ref, qp, act)))
    tile_step = jax_kernels._build_tile_step(ref)

    def jnp_path(x):
        from brax_tpu.sim.types import QP as JaxQP

        with lowering.kernel_mode():
            qp, info = step(JaxQP(*(jnp.asarray(v) for v in x[:4])), jnp.asarray(x[4]))
        return [np.asarray(v, np.float64) for v in (qp.pos, qp.rot, qp.vel, qp.ang,
                                                     info.contact.vel, info.contact.ang)]

    def pallas_path(x):
        soa = lambda v: jnp.asarray(np.transpose(v, (1, 2, 0)))
        outs = tile_step(*(soa(v) for v in x[:4]), jnp.asarray(x[4].T))
        return [np.transpose(np.asarray(o, np.float64), (2, 0, 1)) for o in outs]

    rs = np.random.RandomState(0)
    noisy = [np.repeat(x, COPIES, axis=0) for x in ins]
    noisy = [(x * (1 + NOISE * rs.uniform(-1, 1, x.shape))).astype(np.float32)
             if i < 4 else x for i, x in enumerate(noisy)]
    paths = {"twin float32": (twin(port, ins, torch.float32), None),
             "JAX jnp": (jnp_path(ins), jnp_path(noisy)),
             "JAX Pallas": (pallas_path(ins), pallas_path(noisy))}
    kept = FIELDS if one_pass else ("vel", "contact_ang")
    fields = {k: d[f"kernel_{k}"] for k in kept}
    for i in range(n):
        print(f"env {int(index[i])}: distance to the float64 twin (JAX spread over {COPIES} "
              f"copies with {NOISE:g} relative noise)")
        for k, kernel_out in fields.items():
            f = FIELDS.index(k)
            ref64 = f64[f][i]
            kernel = float(np.abs(kernel_out[i] - ref64).max())
            line, inside = [], []
            for pname, (out, cop) in paths.items():
                dist = float(np.abs(out[f][i] - ref64).max())
                if cop is None:
                    line.append(f"{pname} {dist:.3e}")
                    continue
                spread = float(np.abs(cop[f][i * COPIES:(i + 1) * COPIES] - ref64).max())
                line.append(f"{pname} {dist:.3e} (spread {spread:.3e})")
                inside.append(kernel <= max(spread, dist))
            print(f"  {k:12s} CUDA kernel {kernel:.3e}; " + "; ".join(line)
                  + f"; kernel inside a JAX path's spread: {any(inside)}")


if __name__ == "__main__":
    main(*sys.argv[1:])

"""Semi-implicit Euler in joint coordinates, batch-first.

Counterpart of `brax_tpu/v2/generalized/integrator.py`: velocities first,
then positions; free-joint quaternions advance by the exact exponential of
the angular velocity and are normalised.  Norms are summed as `ordered`
sums them: the generalized kernel's plain version runs `integrate` as it is.
"""

from __future__ import annotations

import torch

from brax_torch import maths
from brax_torch.v2 import ordered, scan
from brax_torch.v2.base import System, Tensor


def integrate(sys: System, q: Tensor, qd: Tensor, qdd: Tensor, dt: float):
    """One step of dt of (q (N, nq), qd (N, nd)) under the acceleration qdd."""
    qd = qd + qdd * dt
    q_off, qd_off = scan.offsets(sys.link_types)
    outs = []
    for t, qo, do in zip(sys.link_types, q_off, qd_off):
        if t != "f":
            w = int(t)
            outs.append(q[:, qo:qo + w] + qd[:, do:do + w] * dt)
            continue
        ang = qd[:, do + 3:do + 6]
        ang_norm = torch.sqrt(ordered.sumsq(ang)) + 1e-8
        qrot = maths.quat_rot_axis(ang / ang_norm[:, None], dt * ang_norm)
        rot = maths.quat_mul(q[:, qo + 3:qo + 7], qrot)
        outs += [q[:, qo:qo + 3] + qd[:, do:do + 3] * dt,
                 rot / torch.sqrt(ordered.sumsq(rot))[:, None]]
    return torch.cat(outs, dim=1), qd

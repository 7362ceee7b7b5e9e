"""The generalized physics pipeline, batch-first.

Counterpart of `brax_tpu/v2/generalized/pipeline.py`.  `step` runs
act -> tau -> smooth forces -> constraint forces -> qdd -> integrate, then
refreshes kinematics, contacts, CoM terms, the mass matrix (Newton-Schulz,
warm-started) and the constraint rows.  This is the route without the CUDA
kernel (`use_kernel=False` in `brax_torch.v2.envs`).
"""

from __future__ import annotations

import torch

from brax_torch.v2 import actuator, kinematics
from brax_torch.v2.base import System, Tensor
from brax_torch.v2.generalized import constraint, dynamics, integrator, mass
from brax_torch.v2.generalized.base import State
from brax_torch.v2.geometry import contact as geometry


def _refresh(sys: System, state: State, q: Tensor, qd: Tensor, approximate: bool) -> State:
    x, xd = kinematics.forward(sys, q, qd)
    state = state.replace(q=q, qd=qd, x=x, xd=xd, contact=geometry.contact(sys, x))
    state = dynamics.transform_com(sys, state)
    state = mass.matrix_inv(sys, state, approximate=approximate)
    return constraint.jacobian(sys, state)


def init(sys: System, q: Tensor, qd: Tensor) -> State:
    """The pipeline state of joint positions q (N, nq) and velocities qd."""
    return _refresh(sys, State.zero(sys, q.shape[0]), q, qd, approximate=False)


def step(sys: System, state: State, act: Tensor) -> State:
    """One physics step of the batch."""
    tau = actuator.to_tau(sys, act, state.q)
    state = state.replace(qf_smooth=dynamics.forward(sys, state, tau))
    state = state.replace(qf_constraint=constraint.force(sys, state))
    # dof damping folds into M^-1 by the first-order expansion of the inverse:
    # (A + eX)^-1 ~ A^-1 - e A^-1 X A^-1
    mx_inv = state.mass_mx_inv
    mx_inv_damp = mx_inv - mx_inv @ (torch.diag(sys.dof.damping) * sys.dt) @ mx_inv
    qdd = (mx_inv_damp @ (state.qf_smooth + state.qf_constraint)[..., None])[..., 0]
    state = state.replace(qdd=qdd)
    q, qd = integrator.integrate(sys, state.q, state.qd, qdd, sys.dt)
    return _refresh(sys, state, q, qd, approximate=True)

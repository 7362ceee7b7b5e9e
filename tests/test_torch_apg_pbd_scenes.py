"""APG's v1 physics gradients on grasp, fetch and the spring ant, on the CPU.

tests/test_es_ars_apg.py's check that APG's gradients flow through the
contact solvers of grasp and fetch (the claw and ball, the dog's feet),
mirrored against the JAX package: each env reset, settled by 3 steps of
zero action, then one step's d(reward)/d(action) at the zero action and
d(reward)/d(qp), through the port's `kernels.PBDStep`, against `jax.grad`
through the JAX env's jnp step (tests/apg_parity.py states the
tolerance).  The spring ant, whose twin is the legacy-spring step, is held
the same way at an action in [-0.3, 0.3].  And the polynomial arctan2
that the twin's joint angles go through keeps a finite gradient where
its argument is tiny (its unused 1/t branch once made it NaN, on fetch).
"""

import numpy as np
import pytest
import torch

from brax_torch import maths

from tests import apg_parity as ap
from tests.torch_parity import one_torch_thread  # noqa: F401

@pytest.mark.parametrize("scene", sorted(ap.SCENES))
def test_reward_gradients_match_jax(scene):
    step, state, act, jax_env, keys = ap.scene_inputs(scene)
    got = ap.port_reward_grads(step, state, torch.from_numpy(act))
    want = ap.jax_reward_grads(jax_env, state, act, keys=keys)
    ap.assert_grads_close(got, want, f"{scene} ")
    assert float(np.abs(want["act"]).max()) > 0


def test_arctan2_gradient_is_finite_at_tiny_ratios():
    y = torch.tensor([1e-30, -1e-25, 0.0, 3e-8, 1.0], requires_grad=True)
    x = torch.tensor([1.0, 2.0, 1.0, -1.0, 1e-8], requires_grad=True)
    gy, gx = torch.autograd.grad(maths.arctan2(y, x).sum(), (y, x))
    assert bool(torch.isfinite(gy).all()) and bool(torch.isfinite(gx).all())
    # d atan2(y, x)/dy = x / (x^2 + y^2) where y/x is tiny
    torch.testing.assert_close(gy[:3], 1 / x[:3].detach(), rtol=1e-6, atol=0)

"""APG's v1 physics gradients on the CPU: `brax_torch.sim.kernels.PBDStep`.

The Function (the twin forward here, the kernel forward on the card; a
backward that runs the twin again from the saved inputs) is held bit for
bit to autograd straight through the twin (`pbd_step_plain`), in both
dynamics modes, for a fixed random linear functional of all six outputs
(`brax_torch.tools.grad_parity`); under no_grad it saves nothing.  The
ant's reward gradients through 2 steps in ground contact, w.r.t. the
action and the state, are held to `jax.grad` through the JAX env's jnp
step (tests/apg_parity.py states the tolerance).  Faults planted in the
Function (tests/apg_faults.py) must fail these checks.
"""

import numpy as np
import pytest
import torch

from brax_torch.sim import kernels
from brax_torch.sim.types import QP
from brax_torch.tools import grad_parity as gp

from tests import apg_faults
from tests import apg_parity as ap
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ant():
    return ap.settled_ant()


def assert_function_matches_twin(sys_, qp, act):
    """One step's gradients through the Function equal the twin's under
    autograd, bit for bit."""
    ws = gp.weights(gp.pbd_outputs(*kernels.pbd_step_plain(sys_, qp, act)))
    got = gp.pbd_grads(sys_, qp, act, ws, kernels.pbd_step)
    want = gp.pbd_grads(sys_, qp, act, ws, kernels.pbd_step_plain)
    for k in gp.PBD_INPUTS:
        assert torch.equal(got[k], want[k]), f"{k}: max diff {(got[k] - want[k]).abs().max()}"


@pytest.mark.parametrize("legacy_spring", [False, True], ids=["pbd", "legacy_spring"])
def test_function_gradients_equal_the_twins_bit_for_bit(ant, legacy_spring):
    env, state, act = ant if not legacy_spring else ap.settled_ant(legacy_spring=True)
    assert bool((state.obs[:, 27:].abs() > 0).any(dim=1).all()), "every ant in contact"
    assert_function_matches_twin(env.sys, state.qp, act)
    out, _ = kernels.pbd_step(env.sys, QP(*(t.requires_grad_() for t in (
        state.qp.pos.clone(), state.qp.rot.clone(), state.qp.vel.clone(),
        state.qp.ang.clone()))), act)
    assert type(out.pos.grad_fn).__name__ == "PBDStepBackward"


def test_no_grad_saves_nothing(ant):
    env, state, act = ant
    qp_grad = QP(*(t.clone().requires_grad_() for t in (state.qp.pos, state.qp.rot,
                                                        state.qp.vel, state.qp.ang)))
    with torch.no_grad():
        (out, _), saved = gp.saved_tensors(lambda: kernels.pbd_step(env.sys, qp_grad, act))
    assert saved == 0 and out.pos.grad_fn is None
    (out, _), saved = gp.saved_tensors(lambda: kernels.pbd_step(env.sys, state.qp, act))
    assert saved == 0 and out.pos.grad_fn is None
    # recorded: the Function saves its five inputs and nothing else
    (out, info), saved = gp.saved_tensors(lambda: kernels.pbd_step(env.sys, qp_grad, act))
    assert saved == 5
    calls = kernels.PBDStep.backward_calls
    (out.pos.sum() + info.contact.vel.sum()).backward()
    assert kernels.PBDStep.backward_calls == calls + 1


def test_ant_reward_gradients_match_jax_through_two_contact_steps(ant):
    """d(reward)/d(action) and d(reward)/d(qp) of 2 ant steps in contact,
    the action held (tests/test_es_ars_apg.py's check), against jax.grad."""
    env, state, act = ant
    got = ap.port_reward_grads(env.step, state, act, steps=2)
    want = ap.jax_reward_grads(tp.jax_ant(), state, act.numpy(), steps=2)
    ap.assert_grads_close(got, want, "ant ")
    assert float(np.abs(want["act"]).max()) > 0


@pytest.mark.parametrize("fault", ["contact_cotangents_dropped", "linearised_at_outputs",
                                   "act_grad_zeroed"])
def test_planted_fault_fails(ant, fault):
    env, state, act = ant
    with apg_faults.planted(fault):
        with pytest.raises(AssertionError):
            assert_function_matches_twin(env.sys, state.qp, act)

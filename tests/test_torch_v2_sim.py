"""brax_torch.v2's System, loader and generalized pipeline against the JAX
package's, on the CPU.

16 ant states (`torch_parity.v2_inputs`: noisy init_q with the torso
lowered so that every env has a foot on the floor) go through
`jax.jit(jax.vmap(...))` of the JAX pipeline and through the port.  Every
System leaf is held at rtol 1e-5; positions, rotations and the mass matrix
at 1e-5, velocities, accelerations and forces at 1e-4 (rtol and atol), the
tolerances tests/test_v2_generalized_kernel.py holds the JAX kernel to.
"""

import numpy as np
import pytest
import torch

from brax_torch.v2 import actuator, kinematics, mjcf
from brax_torch.v2.base import System
from brax_torch.v2.envs import assets
from brax_torch.v2.generalized import constraint, dynamics, mass, pipeline
from brax_torch.v2.generalized.base import State
from brax_torch.v2.geometry import contact

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

POS_TOL = dict(rtol=1e-5, atol=1e-5)
VEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def sys():
    return mjcf.loads(assets.ant_xml(), device="cpu")


@pytest.fixture(scope="module")
def inputs():
    return tuple(torch.from_numpy(x) for x in tp.v2_inputs())


@pytest.fixture(scope="module")
def port_init(sys, inputs):
    q, qd, _ = inputs
    return pipeline.init(sys, q, qd)


@pytest.mark.parametrize("how", ["from_numpy", "mjcf"])
def test_system_matches_jax_leaves(sys, how):
    """Every leaf and static field of the JAX ant System, invweight too."""
    want = tp.tree(tp.jax_v2_ant().sys)
    got = System.from_numpy(want) if how == "from_numpy" else sys
    got_leaves = list(tp.leaves(tp.tree(got)))
    want_leaves = list(tp.leaves(want))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        if isinstance(b, np.ndarray):
            assert a.shape == b.shape, path
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=path)
        else:
            assert a == b, path
    assert got.link_types == "f11111111" and got.solver_iterations == 4


def test_kinematics_and_contact(sys, inputs):
    s0, _ = tp.jax_v2_states()
    q, qd, _ = inputs
    x, xd = kinematics.forward(sys, q, qd)
    _close(x.pos, s0.x.pos, POS_TOL)
    _close(x.rot, s0.x.rot, POS_TOL)
    _close(xd.ang, s0.xd.ang, VEL_TOL)
    _close(xd.vel, s0.xd.vel, VEL_TOL)
    c = contact.contact(sys, x)
    _close(c.pos, s0.contact.pos, POS_TOL)
    _close(c.penetration, s0.contact.penetration, POS_TOL)
    _close(c.normal, s0.contact.normal, POS_TOL)
    _close(c.friction, s0.contact.friction, POS_TOL)
    assert (c.penetration > 0).any(dim=1).all()


def test_contact_points_and_unnormalised_rotations(sys, inputs):
    """Ant's four foot spheres, folded once per System; link velocities turn
    by the rotations before normalisation, as the JAX pipeline's do."""
    pts = contact.points(sys)
    assert pts.link == [2, 4, 6, 8] and contact.points(sys) is pts
    np.testing.assert_array_equal(pts.normal, np.tile([0.0, 0.0, 1.0], (4, 1)))
    q, qd, _ = inputs
    x_pos, raw = kinematics.transforms(sys, q, unit=False)
    _, unit = kinematics.transforms(sys, q)
    x, xd = kinematics.forward(sys, q, qd)
    xd_ang, _ = kinematics.motions(sys, q, qd, x_pos, raw)
    assert torch.equal(xd.ang, torch.stack(xd_ang, dim=1))
    assert torch.equal(x.rot, torch.stack(unit, dim=1))
    _close(torch.stack(unit, dim=1).norm(dim=-1), np.ones((q.shape[0], 9)), POS_TOL)


def test_transform_com(sys, inputs):
    s0, _ = tp.jax_v2_states()
    q, qd, _ = inputs
    x, xd = kinematics.forward(sys, q, qd)
    state = dynamics.transform_com(sys, State.zero(sys, q.shape[0]).replace(q=q, qd=qd, x=x, xd=xd))
    _close(state.com, s0.com, POS_TOL)
    _close(state.cinr.i, s0.cinr.i, POS_TOL)
    _close(state.cinr.transform.pos, s0.cinr.transform.pos, POS_TOL)
    _close(state.cinr.mass, s0.cinr.mass, POS_TOL)
    for f in ("cd", "cdof", "cdofd"):
        for part in ("ang", "vel"):
            _close(getattr(getattr(state, f), part), getattr(getattr(s0, f), part), VEL_TOL)


def test_mass_matrix_and_inverses(sys, port_init):
    """The exact inverse at init, and Newton-Schulz warm-started from it at
    the state one JAX step on."""
    s0, s1 = tp.jax_v2_states()
    _close(mass.matrix(sys, port_init), s0.mass_mx, POS_TOL)
    _close(port_init.mass_mx_inv, s0.mass_mx_inv, VEL_TOL)
    q1, qd1 = _t(s1.q), _t(s1.qd)
    x, xd = kinematics.forward(sys, q1, qd1)
    state = dynamics.transform_com(sys, port_init.replace(q=q1, qd=qd1, x=x, xd=xd))
    state = state.replace(mass_mx_inv=_t(s0.mass_mx_inv))
    ns = mass.matrix_inv(sys, state, approximate=True)
    _close(ns.mass_mx, s1.mass_mx, POS_TOL)
    _close(ns.mass_mx_inv, s1.mass_mx_inv, VEL_TOL)


def test_constraint_rows_and_force(sys, inputs, port_init):
    s0, s1 = tp.jax_v2_states()
    _close(port_init.con_jac, s0.con_jac, POS_TOL)
    _close(port_init.con_pos, s0.con_pos, POS_TOL)
    _close(port_init.con_diag, s0.con_diag, POS_TOL)
    assert (port_init.con_pos < 0).sum() > 10
    state = port_init.replace(qf_smooth=_t(s1.qf_smooth))
    _close(constraint.force(sys, state), s1.qf_constraint, VEL_TOL)


def test_actuator_to_tau(sys, inputs):
    import jax
    from brax_tpu.v2 import actuator as jax_actuator

    q, _, act = inputs
    jsys = tp.jax_v2_ant().sys
    want = jax.jit(jax.vmap(lambda a, qq: jax_actuator.to_tau(jsys, a, qq)))(
        act.numpy() * 2, q.numpy())
    _close(actuator.to_tau(sys, act * 2, q), want, POS_TOL)


def test_pipeline_init_and_step(sys, inputs, port_init):
    s0, s1 = tp.jax_v2_states()
    _, _, act = inputs
    s1_port = pipeline.step(sys, port_init, act)
    for got, want in ((port_init, s0), (s1_port, s1)):
        for f in ("q", "mass_mx"):
            _close(getattr(got, f), getattr(want, f), POS_TOL)
        _close(got.x.pos, want.x.pos, POS_TOL)
        _close(got.x.rot, want.x.rot, POS_TOL)
        _close(got.contact.pos, want.contact.pos, POS_TOL)
        _close(got.contact.penetration, want.contact.penetration, POS_TOL)
        _close(got.con_jac, want.con_jac, POS_TOL)
        for f in ("qd", "mass_mx_inv"):
            _close(getattr(got, f), getattr(want, f), VEL_TOL)
        _close(got.xd.ang, want.xd.ang, VEL_TOL)
        _close(got.xd.vel, want.xd.vel, VEL_TOL)
    for f in ("qf_smooth", "qf_constraint", "qdd"):
        _close(getattr(s1_port, f), getattr(s1, f), VEL_TOL)

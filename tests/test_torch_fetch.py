"""v1 fetch, hopper and walker2d of brax_torch against the JAX package, on
the CPU: the builds, `default_qp` with box colliders, the PBD step
(`pbd_step_plain`) from fetch's states, and the Pallas kernel body.

fetch's scene: 13 bodies (a torso, shoulders, four two-link legs, the
frozen Ground and Target), 10 revolute joints with torque actuators, 4
substeps, and one contact group: a one-way box-plane group of the four
lower legs' boxes against the Ground, eight corners each, 32 contact
points.  Its states (`pbd_parity.fetch_states`): a reset, where
`default_qp` has put the lowest corners exactly on the ground, on uniform
actions, and its feet on the ground (2-4 corners of each lower leg's box
below it) after 15 twin steps of a small held torque.  hopper and
walker2d need nothing new (one-way capsule-plane contacts).

The step is held against `jax.vmap(system._raw_step)` traced in the JAX
package's kernel mode (tests/forces_parity.py::jax_raw_step says why):
pos, rot and vel at ONE_STEP, ang and the contact impulses at the rounding
rule's TOLERANCE (`pbd_parity`), as grasp's are held.
"""

import jax
import numpy as np
import pytest
import torch

from brax_tpu.envs.assets.fetch import fetch_config as jax_fetch_config
from brax_tpu.envs.assets.hopper import hopper_config as jax_hopper_config
from brax_tpu.envs.assets.walker2d import walker2d_config as jax_walker2d_config
from brax_tpu.sim import builder as jax_builder
from brax_tpu.sim import initial as jax_initial
from brax_torch.envs.assets.fetch import fetch_config
from brax_torch.envs.assets.hopper import hopper_config
from brax_torch.envs.assets.walker2d import walker2d_config
from brax_torch.sim import builder, initial, kernels
from brax_torch.sim.system import flatten
from brax_torch.tools.pbd_parity import (FETCH_STATES, TOLERANCE, corners_down, fields,
                                         one_pass)

from tests import fetch_parity as fpar
from tests import forces_parity as fp
from tests import grasp_parity as gp
from tests.test_torch_sim import _assert_tables_equal
from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

CONFIGS = {"fetch": (fetch_config, jax_fetch_config),
           "hopper": (hopper_config, jax_hopper_config),
           "walker2d": (walker2d_config, jax_walker2d_config)}
# (bodies, joints, substeps, contact groups) of each scene
SHAPES = {"fetch": (13, 10, 4, [("BoxPlane", True)]),
          "hopper": (5, 3, 4, [("CapsulePlane", True)]),
          "walker2d": (8, 6, 4, [("CapsulePlane", True)])}
# the fields held at ONE_STEP; the others at TOLERANCE
EXACT = ("pos", "rot", "vel")


@pytest.mark.parametrize("name", fpar.NAMES)
def test_build_matches_jax_leaf_for_leaf(name):
    """Each System, table for table; fetch's box-plane group holds each
    lower leg's eight corners in the JAX builder's order, and every group
    is one the kernel covers."""
    port, ref = CONFIGS[name]
    sys, _ = builder.build(port(), device="cpu")
    jax_sys, _ = jax_builder.build(ref())
    _assert_tables_equal(flatten(sys), flatten(jax_sys))
    nb, nj, substeps, groups = SHAPES[name]
    assert (sys.num_bodies, sum(g.n for g in sys.joint_groups), sys.substeps) == (
        nb, nj, substeps)
    assert [(type(c).__name__, c.com.one_way) for c in sys.contact_groups] == groups
    assert [g.kind for g in sys.joint_groups] == ["revolute"]
    assert kernels.unsupported_features(sys, fpar.ACTION[name]) == []
    if name == "fetch":
        (g,) = sys.contact_groups
        assert g.corner.shape == (4, 8, 3) and sys.num_contacts == 32
        assert g.com.body_a.tolist() == [4, 6, 8, 10] and g.com.body_b.tolist() == [11] * 4


def test_default_qp_with_boxes_matches_jax():
    """fetch's default_qp (its tree lifted so that its lowest box corner sits
    on the ground) against the JAX package's, at the default angles and with
    joint angles of up to 0.5 rad, which put other corners lowest; and
    `_min_z` of each box body of those states against the JAX one."""
    port, ref = CONFIGS["fetch"]
    _, art = builder.build(port(), device="cpu")
    _, jax_art = jax_builder.build(ref())
    noise = np.random.RandomState(0).uniform(-0.5, 0.5, (fpar.N, 10)).astype(np.float32)
    noise[0] = 0.0
    angle = initial.default_angle(art, device="cpu") + torch.from_numpy(noise)
    qp = initial.default_qp(art, joint_angle=angle, device="cpu")
    jfn = jax.jit(jax.vmap(lambda a: jax_initial.default_qp(jax_art, joint_angle=a)))
    want = tp.qp_numpy(jfn(angle.numpy()))
    for got, w in zip((qp.pos, qp.rot, qp.vel, qp.ang), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-6)
    jmin = lambda body: jax.vmap(lambda p, r: jax_initial._min_z(
        jax_initial.QP(pos=p[None], rot=r[None], vel=p[None], ang=p[None]), body))
    bodies = art.config.bodies
    boxes = [i for i, b in enumerate(bodies) if any(c.box is not None for c in b.colliders)]
    assert len(boxes) == 11
    for i in boxes:
        got = initial._min_z(qp.pos[:, i], qp.rot[:, i], bodies[i])
        want = jmin(jax_art.config.bodies[i])(qp.pos[:, i].numpy(), qp.rot[:, i].numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   err_msg=bodies[i].name)
    # the lowest corner of the dog lies on the ground in every env
    lowest = torch.stack([initial._min_z(qp.pos[:, i], qp.rot[:, i], bodies[i])
                          for i in boxes], dim=-1).min(dim=-1).values
    assert float(lowest.abs().max()) < 1e-6


@pytest.mark.parametrize("state", FETCH_STATES)
def test_twin_step_matches_jnp_path(state):
    """One pass and one whole step of the twin from each fetch state
    against the JAX jnp step: pos, rot and vel at ONE_STEP, ang and the
    contact impulses at TOLERANCE, every env.  From a reset the first
    half-substep's fall pushes the lowest corners below the ground; with
    the feet on the ground 2-4 corners of each box are below it."""
    env = fpar.port_env("fetch")
    qp, act = fpar.fetch_states()[state]
    if state == FETCH_STATES[1]:
        down = corners_down(env, qp)
        assert bool((down >= 1).all()) and float(((down >= 2) & (down <= 4)).float().mean()) > 0.9
    jax_sys = fpar.jax_env("fetch").sys
    for passes, sys in ((1, one_pass(env.sys)), (None, env.sys)):
        out, info = kernels.pbd_step_plain(sys, qp, act)
        got = fields(out, info)
        want = gp.jax_step("fetch", jax_sys, qp, act, passes)
        for k in TOLERANCE:
            tol = fp.ONE_STEP[k] if k in EXACT else TOLERANCE[k]
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol,
                                       err_msg=f"{k}, {passes or 'whole step'}")
    legs = [int(b) for b in env.sys.contact_groups[0].com.body_a]
    assert bool((info.contact.vel[:, legs].abs().amax(dim=-1) > 0).all())


def test_twin_matches_pallas_kernel_math():
    """The Pallas kernel body over one pass (run eagerly) from fetch's feet
    on the ground, env by env at TOLERANCE: its corners packed as
    capsule-plane records of radius 0 (brax_tpu/sim/kernels.py:347-357),
    the layout the CUDA kernel takes.  No JAX test ran that path before."""
    env = fpar.port_env("fetch")
    qp, act = fpar.fetch_states()[FETCH_STATES[1]]
    got = fields(*kernels.pbd_step_plain(one_pass(env.sys), qp, act))
    want = gp.pallas_one_pass(fpar.jax_env("fetch").sys, qp, act)
    for k, tol in TOLERANCE.items():
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=tol, err_msg=k)

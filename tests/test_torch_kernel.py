"""The fused PBD step: its plain twin against the Pallas kernel's math, and
the wrapper's CPU behaviour.  The kernel itself is tested on the card by
tests/test_torch_cuda.py and chip_smoke.py.

`brax_tpu.sim.kernels._build_tile_step` is the body of the Pallas kernel that
`brax_torch/csrc/pbd_step.cu` replaces, written in jnp on a (rows, N) lane
layout.  tests/test_pallas_kernel.py runs it jitted on CPU; here it runs
eagerly, because jitting it for ant costs about two minutes of CPU compile
(tests/test_pallas_kernel.py::test_tile_step_math_matches_jnp_path, cold
cache), and eager dispatch gives the same math in a few seconds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.sim import kernels as jax_kernels
from brax_torch.envs.ant import Ant
from brax_torch.envs.humanoid import Humanoid
from brax_torch.sim import kernels
from brax_torch.sim.types import QP

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def states():
    """16 reset states and the same 16 after 10 steps (contact-rich), with actions."""
    env = Ant(use_contact_forces=True, batch_size=tp.N_ENVS, device="cpu")
    qpos, qvel = tp.noise(seed=0)
    reset = env.reset_from_noise(torch.from_numpy(qpos), torch.from_numpy(qvel)).qp
    acts = torch.from_numpy(tp.actions(seed=5, steps=11))
    qp = reset
    for a in acts[:10]:
        qp, _ = kernels.pbd_step_plain(env.sys, qp, a)
    cat = lambda f: torch.cat([getattr(reset, f), getattr(qp, f)])
    both = QP(pos=cat("pos"), rot=cat("rot"), vel=cat("vel"), ang=cat("ang"))
    return env, both, torch.cat([acts[0], acts[10]])


def test_twin_matches_pallas_kernel_math(states):
    """pbd_step_plain against _build_tile_step, from reset (first 16 envs)
    and in contact (last 16), at tests/test_pallas_kernel.py's tolerances."""
    env, qp, act = states
    qp_out, info = kernels.pbd_step_plain(env.sys, qp, act)

    tile_step = jax_kernels._build_tile_step(tp.jax_ant().sys)
    t = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))
    outs = tile_step(t(qp.pos), t(qp.rot), t(qp.vel), t(qp.ang), jnp.asarray(act.numpy().T))
    pos, rot, vel, ang, cvel, cang = [np.transpose(np.asarray(o), (2, 0, 1)) for o in outs]

    n = tp.N_ENVS
    reset, contact = slice(0, n), slice(n, 2 * n)
    got = lambda x, s: x.numpy()[s]
    np.testing.assert_allclose(got(qp_out.pos, reset), pos[reset], atol=2e-5)
    np.testing.assert_allclose(got(qp_out.rot, reset), rot[reset], atol=2e-5)
    np.testing.assert_allclose(got(qp_out.vel, reset), vel[reset], atol=5e-4)
    np.testing.assert_allclose(got(qp_out.ang, reset), ang[reset], atol=5e-4)
    np.testing.assert_allclose(got(info.contact.vel, reset), cvel[reset], atol=5e-4)
    np.testing.assert_allclose(got(info.contact.ang, reset), cang[reset], atol=5e-4)
    assert (np.abs(cvel[contact]) > 0).any(axis=(1, 2)).mean() > 0.5
    np.testing.assert_allclose(got(qp_out.pos, contact), pos[contact], atol=1e-4)
    np.testing.assert_allclose(got(qp_out.vel, contact), vel[contact], atol=3e-3)
    np.testing.assert_allclose(got(info.contact.vel, contact), cvel[contact], atol=3e-3)
    np.testing.assert_allclose(got(info.contact.ang, contact), cang[contact], atol=3e-3)


def test_wrapper_runs_the_twin_on_cpu(states):
    env, qp, act = states
    before = kernels.pbd_step_launch.launches
    qp_out, info = kernels.pbd_step(env.sys, qp, act)
    qp_ref, info_ref = kernels.pbd_step_plain(env.sys, qp, act)
    assert kernels.pbd_step_launch.launches == before
    torch.testing.assert_close(qp_out.pos, qp_ref.pos, rtol=0, atol=0)
    torch.testing.assert_close(info.contact.ang, info_ref.contact.ang, rtol=0, atol=0)
    # as the JAX kernel path: zero joint/actuator info, one placeholder contact
    assert not info.actuator.ang.any() and not info.joint.vel.any()
    assert info.contact_penetration.shape == (qp.pos.shape[0], 1)


def test_pack_tables_layout(states):
    env, _, _ = states
    ftab, itab = kernels.pack_tables(env.sys)
    nb, nj, na, nc = 10, 8, 8, 5
    assert ftab.dtype == np.float32 and itab.dtype == np.int32
    assert ftab.shape == (9 + 14 * nb + 33 * nj + na + 6 * nc,)
    assert itab.shape == (2 * nj + 4 * na + 3 * nc,)
    sys = env.sys
    np.testing.assert_allclose(ftab[0], sys.integrator.dt)
    np.testing.assert_allclose(ftab[9:9 + 14 * nb:14], sys.mass.numpy())
    parents = itab[0:2 * nj:2]
    np.testing.assert_array_equal(parents, sys.joint_groups[0].parent)
    acts = itab[2 * nj:2 * nj + 4 * na].reshape(na, 4)
    np.testing.assert_array_equal(acts[:, 1], sys.actuator_groups[0].act_index[:, 0])
    assert (acts[:, 2:] == -1).all()  # a revolute actuator has one action column
    contacts = itab[2 * nj + 4 * na:].reshape(nc, 3)
    np.testing.assert_array_equal(contacts[:, 1], sys.contact_groups[0].com.body_a)


def test_supported_names_missing_features(states):
    env, _, _ = states
    assert kernels.supported(env.sys)
    # spherical joints are covered: humanoid's System is supported
    assert kernels.supported(Humanoid(batch_size=1, device="cpu").sys)
    acts = (dataclasses.replace(env.sys.actuator_groups[0], kind="angle"),)
    other = dataclasses.replace(env.sys, actuator_groups=acts, collider_cutoff=4)
    assert kernels.unsupported_features(other) == ["collider_cutoff", "angle actuators"]
    assert not kernels.supported(other)

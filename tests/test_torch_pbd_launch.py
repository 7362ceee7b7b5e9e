"""The v1 PBD kernel's generated source and launch plan, on the CPU.

`brax_torch/sim/kernels.py::scene_header` writes each System's scene in
front of `brax_torch/csrc/pbd_step.cu`: counts, topology, the per-body lists
that the body lanes gather, and the values that `pack_tables` packs, as
float literals laid out [field][lane].  These tests parse that header and
hold it to `pack_tables` and to the System, for ant, for ant with two of
its legs removed (8 lanes per env instead of 16), and for the spherical
scenes humanoid (16 lanes) and humanoidstandup (22 contacts: 32 lanes, an
env per warp).  No JAX, no card: the
kernel itself is held to its twin by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from brax_torch.envs import base
from brax_torch.envs.assets.ant import ant_config
from brax_torch.envs.assets.humanoid_new import humanoid_new_config
from brax_torch.envs.assets.humanoid_standup import humanoid_standup_config
from brax_torch.sim import builder, kernels

from tests import pbd_emulation
from tests.torch_parity import one_torch_thread  # noqa: F401

RAGGED = (1, 17, 128, 2048, 4097)
# chip_smoke.py's TOLERANCE: the CPU parity tests' in-contact tolerances
TOLERANCE = {"pos": 1e-4, "rot": 1e-4, "vel": 3e-3, "ang": 3e-3, "contact_vel": 3e-3,
             "contact_ang": 3e-3}
LEGS_REMOVED = {"Aux 3", "$ Body 10", "Aux 4", "$ Body 13"}
JOINTS_REMOVED = {"hip_3", "ankle_3", "hip_4", "ankle_4"}
SCENES = ["ant", "two_legged_ant", "humanoid", "humanoidstandup"]
# (lanes, envs per block) of each scene's plan
LANES = {"ant": (16, 2), "two_legged_ant": (8, 4), "humanoid": (16, 2),
         "humanoidstandup": (32, 1)}


def two_legged_ant_config():
    """ant_config() without its third and fourth legs: their bodies, joints,
    actuators and colliders."""
    cfg = ant_config()
    cfg.bodies = [b for b in cfg.bodies if b.name not in LEGS_REMOVED]
    cfg.joints = [j for j in cfg.joints if j.name not in JOINTS_REMOVED]
    cfg.actuators = [a for a in cfg.actuators if a.joint not in JOINTS_REMOVED]
    cfg.collide_include = [p for p in cfg.collide_include if not LEGS_REMOVED & set(p)]
    return cfg


class Scene(base.Env):
    """A scene config as an env, for its System and default state only."""

    def reset(self, rng):
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError


def scene_state(env, n, steps, seed, device):
    """n states of `env` from its default pose with joint noise, after
    `steps` twin steps with random actions (contact-rich after ~10), and
    one more action."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nd = env.sys.num_joint_dof
    noise = lambda: torch.rand((n, nd), generator=gen, device=device) * 0.2 - 0.1
    qp = env.default_qp(joint_angle=env.default_angle() + noise(), joint_velocity=noise())
    act = lambda: torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    for _ in range(steps):
        qp, _ = kernels.pbd_step_plain(env.sys, qp, act())
    return qp, act()


def _config(name):
    return {"ant": ant_config, "two_legged_ant": two_legged_ant_config,
            "humanoid": humanoid_new_config, "humanoidstandup": humanoid_standup_config}[name]()


def _system(name):
    return builder.build(_config(name), device="cpu")[0]


@pytest.fixture(scope="module", params=SCENES)
def scene(request):
    sys = _system(request.param)
    return request.param, sys, kernels.scene_header(sys)


def _array(header, name):
    """The values of `name`'s initializer in the header, flat, as numpy."""
    m = re.search(rf"const (float|int) {name}((?:\[\d+\])+) = (.*?);\n", header, re.S)
    assert m, name
    dims = [int(d) for d in re.findall(r"\d+", m.group(2))]
    vals = re.findall(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?", m.group(3).replace("f", ""))
    kind = np.float32 if m.group(1) == "float" else np.int64
    return np.asarray([float(v) for v in vals], dtype=np.float64).astype(kind).reshape(dims)


def _define(header, name):
    m = re.search(rf"#define {name} (\S+)\n", header)
    assert m, name
    return m.group(1)


def test_header_literals_equal_pack_tables(scene):
    """Every float literal, parsed back to float32, is pack_tables' value,
    record by record; the lanes past each count hold 0."""
    _, sys, header = scene
    p = kernels.plan(sys)
    ftab, _ = kernels.pack_tables(sys)
    glob = [np.float32(_define(header, k).rstrip("f")) for k in (
        "PBD_DT", "PBD_GRAVITY_X", "PBD_GRAVITY_Y", "PBD_GRAVITY_Z", "PBD_VEL_DECAY",
        "PBD_ANG_DECAY", "PBD_COLLIDE_SCALE", "PBD_H", "PBD_VEL_THRESHOLD")]
    parts = [np.asarray(glob, dtype=np.float32)]
    for name, count in (("BODY_F", p.nb), ("JOINT_F", p.nj), ("ACT_F", p.na),
                        ("CONTACT_F", p.nc)):
        lanes = _array(header, name)  # [field][lane]
        assert lanes.shape[1] == p.lanes
        assert not lanes[:, count:].any()
        parts.append(lanes[:, :count].T.reshape(-1))
    np.testing.assert_array_equal(np.concatenate(parts), ftab)


def test_header_counts_and_plan(scene):
    name, sys, header = scene
    p = kernels.plan(sys)
    assert (p.lanes, p.envs_per_block) == LANES[name]
    spherical = name.startswith("humanoid")
    assert p.spherical == spherical == ("#define PBD_SPHERICAL 1\n" in header)
    kc, kp, ka, kg = p.widths
    want = {"PBD_NB": p.nb, "PBD_NJ": p.nj, "PBD_NA": p.na, "PBD_NC": p.nc, "PBD_NG": p.ng,
            "PBD_PASSES": sys.substeps // 2, "PBD_LANES": p.lanes,
            "PBD_ENVS_PER_BLOCK": p.envs_per_block, "PBD_KC": kc, "PBD_KP": kp, "PBD_KA": ka,
            "PBD_KG": kg}
    assert {k: int(_define(header, k)) for k in want} == want
    assert p.nb == sys.num_bodies
    assert p.nj == sum(g.n for g in sys.joint_groups)
    assert p.na == sum(a.n for a in sys.actuator_groups)
    assert p.nc == sum(c.end.shape[0] * c.end.shape[1] for c in sys.contact_groups)


def test_joint_lists_agree_with_the_system(scene):
    """Each body lane gathers the joints whose child it is, then those whose
    parent it is, in joint order; the header's lanes say the same."""
    _, sys, header = scene
    p = kernels.plan(sys)
    parent = np.concatenate([g.parent for g in sys.joint_groups])
    child = np.concatenate([g.child for g in sys.joint_groups])
    np.testing.assert_array_equal(_array(header, "JOINT_P")[:p.nj], parent)
    np.testing.assert_array_equal(_array(header, "JOINT_C")[:p.nj], child)
    cj, pj = _array(header, "BODY_CJ"), _array(header, "BODY_PJ")
    for b in range(p.nb):
        assert p.body_child_joints[b] == tuple(np.flatnonzero(child == b))
        assert p.body_parent_joints[b] == tuple(np.flatnonzero(parent == b))
        assert [j for j in cj[:, b] if j >= 0] == list(p.body_child_joints[b])
        assert [j for j in pj[:, b] if j >= 0] == list(p.body_parent_joints[b])
    assert (cj[:, p.nb:] == -1).all() and (pj[:, p.nb:] == -1).all()


def test_actuator_lists_agree_with_the_system(scene):
    _, sys, header = scene
    p = kernels.plan(sys)
    joint_of = [g_base + int(j) for a in sys.actuator_groups
                for g_base in [sum(g.n for g in sys.joint_groups[:a.group_index])]
                for j in a.joint_sel]
    # an action column per dof, -1 for a padded dof and past the joint's dofs
    cols = [[int(c) for c in row] + [-1] * (kernels.MAX_DOF - len(row))
            for a in sys.actuator_groups for row in a.act_index]
    assert list(p.act_joint) == joint_of and [list(c) for c in p.act_col] == cols
    header_cols = _array(header, "ACT_COL")  # [dof][lane]
    assert header_cols.shape == (kernels.MAX_DOF, p.lanes)
    np.testing.assert_array_equal(header_cols[:, :p.na].T, cols)
    assert (header_cols[:, p.na:] == -1).all()
    acts, signs = _array(header, "BODY_ACT"), _array(header, "BODY_ACT_SIGN")
    for b in range(p.nb):
        want = [(k, 1 if p.joint_parent[j] == b else -1) for k, j in enumerate(joint_of)
                if b in (p.joint_parent[j], p.joint_child[j])]
        got = [(int(k), int(s)) for k, s in zip(acts[:, b], signs[:, b]) if k >= 0]
        assert got == want == list(p.body_actuators[b])
        assert all(s == 0 for k, s in zip(acts[:, b], signs[:, b]) if k < 0)


def test_contact_lists_agree_with_the_system(scene):
    """Per contact group, each body lane gathers the contacts whose capsule
    it carries, in contact order; every contact's plane is the ground."""
    _, sys, header = scene
    p = kernels.plan(sys)
    body_a = np.concatenate([np.repeat(c.com.body_a, c.end.shape[1]) for c in sys.contact_groups])
    body_b = np.concatenate([np.repeat(c.com.body_b, c.end.shape[1]) for c in sys.contact_groups])
    group = np.concatenate([np.full(c.end.shape[0] * c.end.shape[1], g)
                            for g, c in enumerate(sys.contact_groups)])
    np.testing.assert_array_equal(_array(header, "CONTACT_A")[:p.nc], body_a)
    np.testing.assert_array_equal(_array(header, "CONTACT_B")[:p.nc], body_b)
    con = _array(header, "BODY_CON")  # [group][k][lane]
    assert con.shape[0] == p.ng == len(sys.contact_groups)
    for g in range(p.ng):
        for b in range(p.nb):
            want = list(np.flatnonzero((group == g) & (body_a == b)))
            assert [c for c in con[g, :, b] if c >= 0] == want == list(p.body_contacts[g][b])
    gathered = sorted(c for c in con.reshape(-1) if c >= 0)
    assert gathered == list(range(p.nc))


@pytest.mark.parametrize("n", RAGGED)
def test_launch_plan_covers_ragged_batches(scene, n):
    _, sys, _ = scene
    p = kernels.plan(sys)
    blocks, threads = kernels.launch_geometry(p, n)
    assert threads == p.lanes * p.envs_per_block == kernels.WARP
    assert blocks * p.envs_per_block >= n > (blocks - 1) * p.envs_per_block
    assert p.lanes >= max(p.nb, p.nj, p.nc, p.na)
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes < 2 * max(p.nb, p.nj, p.nc, p.na)


def test_source_path_per_system():
    """A System's source is named by its text's hash: two Systems of one
    config share it, two scenes do not."""
    ant, ant_again, two = _system("ant"), _system("ant"), _system("two_legged_ant")
    path = kernels.kernel_source(ant)
    assert path == kernels.kernel_source(ant_again) == kernels.kernel_source(ant)
    assert len({path, kernels.kernel_source(two), kernels.kernel_source(_system("humanoid")),
                kernels.kernel_source(_system("humanoidstandup"))}) == 4
    assert path.name.startswith("pbd_step_") and path.parent == kernels.BUILD_DIR
    text = path.read_text()
    assert text.startswith(kernels.scene_header(ant))
    assert text.endswith(kernels.SOURCE.read_text())


@pytest.mark.parametrize("change,want", [
    ({}, []),
    ({"collider_cutoff": 4}, ["collider_cutoff"]),
    ({"dynamics_mode": "legacy_spring"}, ["dynamics_mode='legacy_spring'"]),
    ({"scene": "humanoid"}, []),
    ({"actuator_kind": "angle"}, ["angle actuators"]),
    ({"force_groups": ("thruster",)}, ["thruster/twister forces"]),
    ({"num_bodies": 17}, ["17 bodies (the kernel holds 16)"]),
    ({"n_act": 33}, ["33 action columns (the kernel holds 32)"]),
    ({"joint_kind": "spring_spherical"}, ["spring_spherical joints"]),
    ({"scene": "humanoid", "joint_groups": "ant"},
     ["revolute and spherical joints in one System"]),
])
def test_unsupported_features_unchanged(change, want):
    """Spherical joints are covered (humanoid's System misses nothing); a
    spring kind and a System that mixes revolute and spherical groups (which
    `builder.build` never makes) are not."""
    change = dict(change)
    sys = _system(change.pop("scene", "ant"))
    n_act = change.pop("n_act", 0)
    if change.get("joint_groups") == "ant":
        change["joint_groups"] = sys.joint_groups + _system("ant").joint_groups
    if "joint_kind" in change:
        change["joint_groups"] = (dataclasses.replace(sys.joint_groups[0],
                                                      kind=change.pop("joint_kind")),)
    if "actuator_kind" in change:
        change["actuator_groups"] = (dataclasses.replace(sys.actuator_groups[0],
                                                         kind=change.pop("actuator_kind")),)
    other = dataclasses.replace(sys, **change)
    assert kernels.unsupported_features(other, n_act) == want
    if not n_act:
        assert kernels.supported(other) == (not want)


@pytest.mark.parametrize("name,n", [("ant", 37), ("two_legged_ant", 41), ("humanoid", 37),
                                    ("humanoidstandup", 19)])
def test_generated_kernel_lane_logic_matches_twin_in_emulation(name, n):
    """The generated source, compiled for the host with a warp emulated by
    32 threads (tests/pbd_emulation.py), steps ragged batches in contact
    within TOLERANCE of the twin in every env: for the humanoids, the
    spherical joint rows and 3-dof actuators too."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config(name), batch_size=n, device="cpu")
    qp, act = scene_state(env, n, steps=10, seed=0, device="cpu")
    _, info = kernels.pbd_step_plain(env.sys, qp, act)
    assert (info.contact.vel.abs().amax(dim=(1, 2)) > 0).float().mean() > 0.5
    errs = pbd_emulation.max_errors(env.sys, qp, act)
    assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs

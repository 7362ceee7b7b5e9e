"""The v1 PBD kernel's generated source and launch plan, on the CPU.

`brax_torch/sim/kernels.py::scene_header` writes each System's scene in
front of `brax_torch/csrc/pbd_step.cu`: counts, topology, the per-body lists
that the body lanes gather, and the values that `pack_tables` packs, as
float literals laid out [field][lane].  These tests parse that header and
hold it to `pack_tables` and to the System, for ant, for ant with two of
its legs removed (8 lanes per env instead of 16), for the spherical
scenes humanoid (16 lanes) and humanoidstandup (22 contacts: 32 lanes, an
env per warp), for halfcheetah (17 contacts) and pusher (23), whose
two-way capsule-capsule contacts compile PBD_CAPCAP (32 lanes), and for the
scenes without contacts: inverted_pendulum (2 lanes, no actuator),
inverted_double_pendulum and swimmer, whose thrusters compile PBD_FORCES,
reacherangle, whose angle actuators compile PBD_ANGLE, and reacher.  No JAX, no
card: the kernel itself is held to its twin by tests/test_torch_cuda.py and
chip_smoke.py, and here, for its lane logic, in an emulation
(tests/pbd_emulation.py), where faults planted in the capsule-capsule
section (tests/pbd_faults.py) must fail the rule the card holds it to.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from brax_torch.envs import base
from brax_torch.envs.assets.ant import ant_config
from brax_torch.envs.assets.half_cheetah import halfcheetah_config
from brax_torch.envs.assets.humanoid_new import humanoid_new_config
from brax_torch.envs.assets.humanoid_standup import humanoid_standup_config
from brax_torch.envs.assets.inverted_double_pendulum import inverted_double_pendulum_config
from brax_torch.envs.assets.inverted_pendulum import inverted_pendulum_config
from brax_torch.envs.assets.pusher import pusher_config
from brax_torch.envs.assets.reacher import reacher_config
from brax_torch.envs.assets.reacherangle import reacherangle_config
from brax_torch.envs.assets.swimmer import swimmer_config
from brax_torch.sim import builder, colliders, kernels

from brax_torch.tools.pbd_parity import (TOLERANCE, capcap_share, capcap_state, chaos_rule,
                                         fields, one_pass, rounding_rule)
from tests import pbd_emulation, pbd_faults
from tests.torch_parity import one_torch_thread  # noqa: F401

RAGGED = (1, 17, 128, 2048, 4097)
LEGS_REMOVED = {"Aux 3", "$ Body 10", "Aux 4", "$ Body 13"}
JOINTS_REMOVED = {"hip_3", "ankle_3", "hip_4", "ankle_4"}
SCENES = ["ant", "two_legged_ant", "humanoid", "humanoidstandup", "halfcheetah", "pusher",
          "inverted_pendulum", "inverted_double_pendulum", "swimmer", "reacherangle", "reacher"]
CAPCAP_SCENES = ("halfcheetah", "pusher")
FORCE_SCENES = ("inverted_pendulum", "inverted_double_pendulum", "swimmer")
ANGLE_SCENES = ("reacherangle",)
# (lanes, envs per block) of each scene's plan
LANES = {"ant": (16, 2), "two_legged_ant": (8, 4), "humanoid": (16, 2),
         "humanoidstandup": (32, 1), "halfcheetah": (32, 1), "pusher": (32, 1),
         "inverted_pendulum": (2, 16), "inverted_double_pendulum": (4, 8), "swimmer": (4, 8),
         "reacherangle": (4, 8), "reacher": (4, 8)}



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


def scene_state(env, n, steps, seed, device, draw=None):
    """n states of `env` from its default pose with joint noise, after
    `steps` twin steps with random actions (contact-rich after ~10), and
    one more action.  `draw(gen)` draws an action (default: uniform in
    [-1, 1], env.action_size wide)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nd = env.sys.num_joint_dof
    noise = lambda: torch.rand((n, nd), generator=gen, device=device) * 0.2 - 0.1
    qp = env.default_qp(joint_angle=env.default_angle() + noise(), joint_velocity=noise())
    draw = draw or (lambda g: torch.rand((n, env.action_size), generator=g, device=device) * 2 - 1)
    for _ in range(steps):
        qp, _ = kernels.pbd_step_plain(env.sys, qp, draw(gen))
    return qp, draw(gen)


def _config(name):
    return {"ant": ant_config, "two_legged_ant": two_legged_ant_config,
            "humanoid": humanoid_new_config, "humanoidstandup": humanoid_standup_config,
            "halfcheetah": halfcheetah_config, "pusher": pusher_config,
            "inverted_pendulum": inverted_pendulum_config,
            "inverted_double_pendulum": inverted_double_pendulum_config,
            "swimmer": swimmer_config, "reacherangle": reacherangle_config,
            "reacher": reacher_config}[name]()


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


def _has_define(header, name):
    return re.search(rf"#define {name} ", header) is not None


def _contacts_per_pair(c):
    """A capsule-plane pair's cap ends, or 1 for a capsule-capsule pair."""
    return 1 if isinstance(c, colliders.CapsuleCapsule) else c.end.shape[1]


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
    for name, count in (("BODY_F", p.nb), ("JOINT_F", p.nj), ("ACT_F", p.na)):
        lanes = _array(header, name)  # [field][lane]
        assert lanes.shape[1] == p.lanes
        assert not lanes[:, count:].any()
        parts.append(lanes[:, :count].T.reshape(-1))
    # each contact's record from its kind's table; the other table's lane is 0
    plane = _array(header, "CONTACT_F")
    assert plane.shape == (kernels.C_SIZE, p.lanes)
    capcap = (_array(header, "CAPCAP_F") if p.capcap
              else np.zeros((kernels.CC_SIZE, p.lanes), np.float32))
    assert capcap.shape == (kernels.CC_SIZE, p.lanes)
    assert not plane[:, p.nc:].any() and not capcap[:, p.nc:].any()
    for c, is_cc in enumerate(p.contact_capcap):
        assert not (plane if is_cc else capcap)[:, c].any()
        parts.append((capcap if is_cc else plane)[:, c])
    # the force records, lane f holding force f's
    if p.forces:
        forces = _array(header, "FORCE_F")
        assert forces.shape == (kernels.F_SIZE, p.lanes) and not forces[:, p.nf:].any()
        parts.append(forces[:, :p.nf].T.reshape(-1))
    else:
        assert "FORCE_F" not in header
    np.testing.assert_array_equal(np.concatenate(parts), ftab)


def test_capcap_record_is_read_by_its_named_offsets():
    """pbd_step.cu reads the capsule-capsule record by CC_* offsets equal
    to kernels.py's, and the header's CAPCAP_F holds each group field there,
    lane by lane (pusher's 7 pairs)."""
    names = ("CC_END_A", "CC_OFF_A", "CC_RADIUS_A", "CC_END_B", "CC_OFF_B", "CC_RADIUS_B",
             "CC_FRICTION", "CC_ELASTICITY")
    source = kernels.SOURCE.read_text()
    assert [int(_define(source, n)) for n in names] == [getattr(kernels, n) for n in names]
    sys = _system("pusher")
    p = kernels.plan(sys)
    record = _array(kernels.scene_header(sys), "CAPCAP_F")  # [field][lane]
    lanes = [c for c, is_cc in enumerate(p.contact_capcap) if is_cc]
    g = next(c for c in sys.contact_groups if isinstance(c, colliders.CapsuleCapsule))
    for at, field in ((kernels.CC_END_A, g.end_a), (kernels.CC_OFF_A, g.off_a),
                      (kernels.CC_END_B, g.end_b), (kernels.CC_OFF_B, g.off_b)):
        np.testing.assert_array_equal(record[at:at + 3, lanes].T, field.numpy())
    for at, field in ((kernels.CC_RADIUS_A, g.radius_a), (kernels.CC_RADIUS_B, g.radius_b),
                      (kernels.CC_FRICTION, g.com.friction),
                      (kernels.CC_ELASTICITY, g.com.elasticity)):
        np.testing.assert_array_equal(record[at, lanes], field.numpy())


def test_header_counts_and_plan(scene):
    name, sys, header = scene
    p = kernels.plan(sys)
    assert (p.lanes, p.envs_per_block) == LANES[name]
    spherical = name.startswith("humanoid")
    assert p.spherical == spherical == ("#define PBD_SPHERICAL 1\n" in header)
    capcap = name in CAPCAP_SCENES
    assert p.capcap == capcap == ("#define PBD_CAPCAP 1\n" in header)
    assert _has_define(header, "PBD_KGB") == capcap
    if capcap:
        assert int(_define(header, "PBD_KGB")) == p.width_b
    forces = name in FORCE_SCENES
    assert p.forces == forces == ("#define PBD_FORCES 1\n" in header)
    assert _has_define(header, "PBD_NF") == _has_define(header, "PBD_KF") == forces
    if forces:
        assert int(_define(header, "PBD_NF")) == p.nf == sum(f.n for f in sys.force_groups)
        assert int(_define(header, "PBD_KF")) == p.width_f
    assert p.angle == (name in ANGLE_SCENES) == ("#define PBD_ANGLE 1\n" in header)
    kc, kp, ka, kg = p.widths
    want = {"PBD_NB": p.nb, "PBD_NJ": p.nj, "PBD_NA": p.na, "PBD_NC": p.nc, "PBD_NG": p.ng,
            "PBD_PASSES": sys.substeps // 2, "PBD_LANES": p.lanes,
            "PBD_ENVS_PER_BLOCK": p.envs_per_block, "PBD_KC": kc, "PBD_KP": kp, "PBD_KA": ka,
            "PBD_KG": kg}
    assert {k: int(_define(header, k)) for k in want} == want
    assert p.nb == sys.num_bodies
    assert p.nj == sum(g.n for g in sys.joint_groups)
    assert p.na == sum(a.n for a in sys.actuator_groups)
    assert p.nc == sum(len(c.com.body_a) * _contacts_per_pair(c) for c in sys.contact_groups)
    assert p.nc == sys.num_contacts


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
    np.testing.assert_array_equal(header_cols[:, :p.na].T,
                                  np.asarray(cols, dtype=np.int64).reshape(-1, kernels.MAX_DOF))
    angle = [a.kind == "angle" for a in sys.actuator_groups for _ in range(a.n)]
    assert list(p.act_angle) == angle
    if p.angle:
        flags = _array(header, "ACT_ANGLE")
        assert flags.tolist() == [int(x) for x in angle] + [0] * (p.lanes - p.na)
    assert (header_cols[:, p.na:] == -1).all()
    acts, signs = _array(header, "BODY_ACT"), _array(header, "BODY_ACT_SIGN")
    for b in range(p.nb):
        want = [(k, 1 if p.joint_parent[j] == b else -1) for k, j in enumerate(joint_of)
                if b in (p.joint_parent[j], p.joint_child[j])]
        got = [(int(k), int(s)) for k, s in zip(acts[:, b], signs[:, b]) if k >= 0]
        assert got == want == list(p.body_actuators[b])
        assert all(s == 0 for k, s in zip(acts[:, b], signs[:, b]) if k < 0)


def test_contact_lists_agree_with_the_system(scene):
    """Per contact group, each body lane gathers the contacts where it is
    body a (its capsule), then the two-way ones where it is body b, in
    contact order; every contact is gathered once as body a, a two-way one
    once more as body b."""
    _, sys, header = scene
    p = kernels.plan(sys)
    per = [_contacts_per_pair(c) for c in sys.contact_groups]
    # a scene without contacts: empty lists, and one empty group in the header
    cat = lambda parts, dtype: np.concatenate(list(parts) + [np.zeros(0, dtype)])
    body_a = cat((np.repeat(c.com.body_a, k) for c, k in zip(sys.contact_groups, per)), int)
    body_b = cat((np.repeat(c.com.body_b, k) for c, k in zip(sys.contact_groups, per)), int)
    group = cat((np.full(len(c.com.body_a) * k, g)
                 for g, (c, k) in enumerate(zip(sys.contact_groups, per))), int)
    two_way = cat((np.full(len(c.com.body_a) * k, not c.com.one_way)
                   for c, k in zip(sys.contact_groups, per)), bool)
    np.testing.assert_array_equal(_array(header, "CONTACT_A")[:p.nc], body_a)
    np.testing.assert_array_equal(_array(header, "CONTACT_B")[:p.nc], body_b)
    assert list(p.contact_capcap) == two_way.tolist()
    con = _array(header, "BODY_CON")  # [group][k][lane]
    assert con.shape[0] == p.ng == max(len(sys.contact_groups), 1)
    if p.capcap:
        con_b = _array(header, "BODY_CON_B")
        assert con_b.shape == (p.ng, p.width_b, p.lanes)
        np.testing.assert_array_equal(_array(header, "CONTACT_CAPCAP")[:p.nc], two_way)
    else:
        con_b = np.full((p.ng, 1, p.lanes), -1)
    for g in range(p.ng):
        for b in range(p.nb):
            want = list(np.flatnonzero((group == g) & (body_a == b)))
            assert [c for c in con[g, :, b] if c >= 0] == want == list(p.body_contacts[g][b])
            want_b = list(np.flatnonzero((group == g) & (body_b == b) & two_way))
            assert [c for c in con_b[g, :, b] if c >= 0] == want_b == list(
                p.body_contacts_b[g][b])
    assert sorted(c for c in con.reshape(-1) if c >= 0) == list(range(p.nc))
    assert sorted(c for c in con_b.reshape(-1) if c >= 0) == list(np.flatnonzero(two_way))


def test_force_lists_agree_with_the_system(scene):
    """Force f's record sits at lane f: its body, kind and three action
    columns as the System lists them, unclipped; each body lane gathers the
    forces on it in force order.  A scene without forces has no force
    arrays."""
    _, sys, header = scene
    p = kernels.plan(sys)
    body = [int(b) for f in sys.force_groups for b in f.body]
    twister = [f.kind == "twister" for f in sys.force_groups for _ in range(f.n)]
    cols = [tuple(int(c) for c in row) for f in sys.force_groups for row in f.act_index]
    assert (p.nf, list(p.force_twister), list(p.force_col)) == (len(body), twister, cols)
    assert [list(x) for x in p.body_forces] == [
        [f for f in range(p.nf) if body[f] == b] for b in range(p.nb)]
    names = ("FORCE_F", "FORCE_COL", "FORCE_TWISTER", "BODY_FORCE")
    if not p.forces:
        assert not any(name in header for name in names)
        return
    strength = np.concatenate([f.strength.numpy() for f in sys.force_groups])
    mass = np.concatenate([f.mass.numpy() for f in sys.force_groups])
    records = _array(header, "FORCE_F")
    np.testing.assert_array_equal(records[:, :p.nf], np.stack([strength, mass]))
    np.testing.assert_array_equal(_array(header, "FORCE_COL")[:, :p.nf].T, cols)
    assert _array(header, "FORCE_TWISTER")[:p.nf].tolist() == [int(t) for t in twister]
    gather = _array(header, "BODY_FORCE")  # [k][lane]
    assert gather.shape == (p.width_f, p.lanes)
    for b in range(p.lanes):
        assert [f for f in gather[:, b] if f >= 0] == (list(p.body_forces[b]) if b < p.nb else [])


@pytest.mark.parametrize("n", RAGGED)
def test_launch_plan_covers_ragged_batches(scene, n):
    _, sys, _ = scene
    p = kernels.plan(sys)
    blocks, threads = kernels.launch_geometry(p, n)
    assert threads == p.lanes * p.envs_per_block == kernels.WARP
    assert blocks * p.envs_per_block >= n > (blocks - 1) * p.envs_per_block
    assert p.lanes >= max(p.nb, p.nj, p.nc, p.na, p.nf)
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes < 2 * max(p.nb, p.nj, p.nc, p.na, p.nf)


def test_source_path_per_system():
    """A System's source is named by its text's hash: two Systems of one
    config share it, two scenes do not."""
    ant, ant_again, two = _system("ant"), _system("ant"), _system("two_legged_ant")
    path = kernels.kernel_source(ant)
    assert path == kernels.kernel_source(ant_again) == kernels.kernel_source(ant)
    assert len({path, kernels.kernel_source(two), kernels.kernel_source(_system("humanoid")),
                kernels.kernel_source(_system("humanoidstandup")),
                kernels.kernel_source(_system("halfcheetah")),
                kernels.kernel_source(_system("pusher"))}) == 6
    assert path.name.startswith("pbd_step_") and path.parent == kernels.BUILD_DIR
    text = path.read_text()
    assert text.startswith(kernels.scene_header(ant))
    assert text.endswith(kernels.SOURCE.read_text())


@pytest.mark.parametrize("change,want", [
    ({}, []),
    ({"collider_cutoff": 4}, ["collider_cutoff"]),
    ({"dynamics_mode": "legacy_spring"}, ["revolute joints in legacy spring"]),
    ({"scene": "humanoid"}, []),
    ({"scene": "humanoid", "actuator_kind": "angle"}, []),
    ({"scene": "swimmer"}, []),
    ({"num_bodies": 257}, ["257 bodies (the kernel holds 256)"]),
    ({"n_act": 65}, ["65 action columns (the kernel holds 64)"]),
    ({"joint_kind": "spring_spherical"}, ["spring_spherical joints"]),
    ({"scene": "humanoid", "joint_groups": "ant"},
     ["revolute and spherical joints in one System"]),
    ({"scene": "halfcheetah"}, []),
    ({"scene": "pusher"}, []),
    ({"scene": "pusher", "one_way": "CapsuleCapsule"}, []),
    ({"scene": "halfcheetah", "one_way": "CapsulePlane"}, ["two-way CapsulePlane contacts"]),
    ({"scene": "halfcheetah", "actuator_kind": "angle", "box_plane": True},
     ["BoxPlane contacts"]),
    ({"scene": "inverted_pendulum"}, []),
    ({"scene": "reacherangle"}, []),
    ({"scene": "reacher", "actuator_kind": "spring"}, ["spring actuators"]),
    ({"scene": "swimmer", "force_kind": "spring"}, ["spring forces"]),
])
def test_unsupported_features_unchanged(change, want):
    """Spherical joints, capsule-capsule contacts (two-way, and one-way as
    grasp's: pusher's pairs made one-way), thrusters and angle actuators
    (on revolute and, as grasp's, on spherical joints) are covered
    (humanoid's, halfcheetah's, pusher's, swimmer's, inverted_pendulum's
    and reacherangle's Systems miss nothing), and up to 64 action columns
    (grasp's 39); a spring kind in a PBD System, a PBD kind in a
    legacy-spring one (the legacy-spring Systems are covered,
    tests/test_torch_spring_kernel.py), a System that mixes revolute and
    spherical groups (which `builder.build` never makes), a two-way
    capsule-plane group and a group of a class the kernel does not know (a
    stand-in named BoxPlane; the real one-way BoxPlane is covered, fetch's,
    tests/test_torch_fetch_kernel.py) are not."""
    change = dict(change)
    sys = _system(change.pop("scene", "ant"))
    n_act = change.pop("n_act", 0)
    if "one_way" in change:
        kind = getattr(colliders, change.pop("one_way"))
        change["contact_groups"] = tuple(
            dataclasses.replace(c, com=dataclasses.replace(c.com, one_way=not c.com.one_way))
            if isinstance(c, kind) else c for c in sys.contact_groups)
    if change.pop("box_plane", False):
        box_plane = type("BoxPlane", (), {"com": sys.contact_groups[0].com})()
        change["contact_groups"] = sys.contact_groups + (box_plane,)
    if change.get("joint_groups") == "ant":
        change["joint_groups"] = sys.joint_groups + _system("ant").joint_groups
    if "joint_kind" in change:
        change["joint_groups"] = (dataclasses.replace(sys.joint_groups[0],
                                                      kind=change.pop("joint_kind")),)
    if "actuator_kind" in change:
        change["actuator_groups"] = (dataclasses.replace(sys.actuator_groups[0],
                                                         kind=change.pop("actuator_kind")),)
    if "force_kind" in change:
        change["force_groups"] = (dataclasses.replace(sys.force_groups[0],
                                                      kind=change.pop("force_kind")),)
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


@pytest.mark.parametrize("name,n,state", [("halfcheetah", 17, "settled"),
                                          ("halfcheetah", 17, "capcap"),
                                          ("pusher", 9, "capcap")])
def test_capcap_lane_logic_matches_twin_in_emulation(name, n, state):
    """The generated PBD_CAPCAP source in emulation: halfcheetah after 10
    twin steps (its feet on the floor), and both scenes from states whose
    two-way capsule-capsule pairs overlap (capcap_state), so that the
    capsule-capsule lanes, the two-way passes and the body-b gathers run.
    pusher: every env within TOLERANCE of the twin.  halfcheetah, whose
    step is chaotic: within the twin's own rounding spread (chaos_rule)."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config(name), batch_size=n, device="cpu")
    if state == "settled":
        qp, act = scene_state(env, n, steps=10, seed=0, device="cpu")
    else:
        qp, act = capcap_state(name, env, n, seed=0, device="cpu")
        assert capcap_share(env.sys, qp) > 0.9
    ref, info = kernels.pbd_step_plain(env.sys, qp, act)
    assert (info.contact.vel.abs().amax(dim=(1, 2)) > 0).float().mean() > 0.5
    if state == "capcap":
        b = int(env.sys.contact_groups[1].com.body_b[0])
        assert (info.contact.vel[:, b].abs().amax(dim=1) > 0).float().mean() > 0.5
    want = fields(ref, info)
    got = dict(zip(want, pbd_emulation.emulate(env.sys, qp, act)))
    if name == "halfcheetah":
        report, strays, allowed = chaos_rule(env.sys, qp, act, got, want)
        assert len(strays) <= allowed, (strays, report)
    else:
        errs = {k: float((got[k] - want[k]).abs().max()) for k in TOLERANCE}
        assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs


@pytest.mark.parametrize("name,n", [("halfcheetah", 17), ("pusher", 9)])
def test_capcap_one_pass_matches_twin_in_emulation(name, n):
    """Over one pass (pbd_parity.one_pass: what the kernel's loop repeats),
    from states whose capsule-capsule pairs overlap, the emulated kernel
    holds every env of both scenes within TOLERANCE of the twin: the
    rounding rule the card holds its one-pass build to, with no outlier."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config(name), batch_size=n, device="cpu")
    qp, act = capcap_state(name, env, n, seed=0, device="cpu")
    errs = pbd_emulation.max_errors(one_pass(env.sys), qp, act)
    assert all(errs[k] <= TOLERANCE[k] for k in TOLERANCE), errs


@pytest.mark.parametrize("name,n,fault", [
    (name, n, fault) for name, n in (("halfcheetah", 17), ("pusher", 9))
    for fault in sorted(pbd_faults.FAULTS) if name in pbd_faults.FAULT_SCENES[fault]])
def test_planted_capcap_fault_fails_the_one_pass_rule(name, n, fault):
    """A fault planted in a copy of the capsule-capsule section
    (tests/pbd_faults.py: body b's sign, gathers, lever arm and mass, the
    friction),
    emulated over one pass from states whose pairs overlap, fails the
    rounding rule (pbd_parity.rounding_rule): the rule can fail a wrong
    kernel."""
    if pbd_emulation.compiler() is None:
        pytest.skip("needs a host C++ compiler for the emulation")
    env = Scene(_config(name), batch_size=n, device="cpu")
    qp, act = capcap_state(name, env, n, seed=0, device="cpu")
    sys = one_pass(env.sys)
    got = dict(zip(TOLERANCE, pbd_emulation.emulate(sys, qp, act, pbd_faults.planted_text(fault))))
    r = rounding_rule(sys, qp, act, got, torch.Generator().manual_seed(7))
    assert not r["passes"], (len(r["outliers"]), r["errs"])

"""The port's biggym registry (`brax_torch/biggym`) against the JAX package's.

After `register_all()` and `register_matches()` both registries hold the
same env names in the same order, the same tracks, components and match
pools; every one of the 12 scenes builds the same System table for table,
with the same widths, agent groups and component indices, and is one the
PBD kernel covers; and the mirrors of tests/test_biggym.py's checks
(`inspect_env`, `assert_env_params`, the submission format's rejection of
bad metadata, `create_fn`, a contributed component's track envs) hold.
"""

import pytest
import torch

from brax_torch.biggym import registry as registry_pkg
from brax_torch.biggym import tasks
from brax_torch.composer import components as cc
from brax_torch.sim import kernels
from brax_torch.sim.system import flatten

from tests import biggym_parity as bp
from tests.test_torch_sim import _assert_tables_equal
from tests.torch_parity import one_torch_thread  # noqa: F401

# (bodies, contact points, lanes an env, obs width, action width) per scene
SHAPES = {
    "race_ant_ant": (10, 5, 16, 81, 8), "sumo_ant_ant": (19, 35, 64, 162, 16),
    "jump_cheetah": (8, 17, 32, 18, 6), "race_proant_ant": (10, 18, 32, 81, 8),
    "chase_proant_ant": (19, 37, 64, 162, 16), "sumo_proant_ant": (19, 117, 128, 162, 16),
    "match_race_ma__ant_ant__proant_ant": (19, 73, 128, 162, 16),
    "match_sumo__ant_ant__proant_ant": (39, 73, 128, 164, 16),
    **{f"match_onigokko_{role}__{pair}": (19, 73, 128, 164, 16)
       for role in ("prey", "predator") for pair in ("ant_ant__proant_ant", "proant_ant__ant_ant")},
}


def test_registry_matches_jax():
    """The registries, tracks and pools of both packages, and the mirrors of
    tests/test_biggym.py."""
    jb, pb = bp.jax_registry(), bp.registry()
    assert registry_pkg.REGISTRIES == sorted(registry_pkg.REGISTRIES)
    assert list(pb.ENVS) == jb["envs"]
    assert sorted(pb.ENVS) == sorted(SHAPES)
    assert {k: list(v) for k, v in pb.ENVS_BY_TRACKS.items()} == jb["tracks"]
    assert pb.COMPONENTS_BY_TRACKS == jb["pools"]
    assert pb.COMPONENTS == jb["components"]
    assert sorted(pb.REGISTRIES) == sorted(jb["registries"])
    for name, got in pb.REGISTRIES.items():
        want = jb["registries"][name]
        for f in ("envs", "components", "task_envs"):
            assert got[f] == want[f], (name, f)
        assert sorted(got["metadata"]) == want["metadata"]
    assert pb.list_env() == jb["list_env"]
    assert [list(tasks.TASKS), list(tasks.MATCH_TASKS), list(tasks.SYMMETRIC_MA_TASKS),
            list(tasks.ASYMMETRIC_MA_TASKS)] == jb["tasks"]
    assert tasks.get_match_env_name("sumo", "a", "b") == "match_sumo__a__b"
    # the jump submission's mimax track registered its obs indices
    from brax_torch.braxlines import obs_indices as oi

    assert oi.get_indices("jump_cheetah", "vel") == ((10,), 5.0)
    # idempotent
    assert pb.register_module("jump")[0] == ["jump_cheetah"]
    with pytest.raises(AssertionError):
        pb.register_match("sumo", "ant_ant", "proant_ant")

    # inspect_env / assert_env_params / bad metadata / create_fn
    supported, _ = pb.inspect_env("ant")
    assert "use_contact_forces" in supported
    pb.assert_env_params("ant", {"use_contact_forces": True})
    with pytest.raises(AssertionError):
        pb.assert_env_params("ant", {"no_such_param": 1}, ignore_kwargs=False)
    with pytest.raises(AssertionError):
        pb._validate_metadata(object(), "x")
    with pytest.raises(AssertionError):
        pb.assert_exists("race_no_such_component")
    assert pb.create_fn("ant", episode_length=8, batch_size=2, device="cpu")().action_size == 8

    # a contributed component enters every single-agent track
    def pogo():
        from brax_torch.envs.assets.hopper import hopper_config

        return cc.ComponentSpecs(config=cc._strip_ground(hopper_config()), root="torso",
                                 collides=("torso", "foot"), observers=("root_z_joints",))

    created = pb.register("pogo_torch", component_fn=pogo)
    assert set(created) == {"race_pogo_torch", "chase_pogo_torch", "sumo_pogo_torch"}
    env = pb.create("sumo_pogo_torch", episode_length=16, auto_reset=False, batch_size=2,
                    device="cpu")
    state = env.step(env.reset(torch.Generator().manual_seed(0)),
                     torch.zeros((2, env.action_size)))
    assert state.reward.shape == (2, 2) and bool(torch.isfinite(state.reward).all())


def test_every_scene_builds_as_jax():
    """Each of the 12 scenes' System, table for table, its widths and (for a
    composed scene) agent groups and component indices; the kernel covers
    each, on one warp or on the wide route (128 lanes for 73 and 117
    contact points)."""
    for scene, (nb, nc, lanes, obs, act) in SHAPES.items():
        env, jenv = bp.port_env(scene, 2), bp.new_jax_env(scene)
        _assert_tables_equal(flatten(env.sys), flatten(jenv.sys))
        p = kernels.plan(env.sys)
        assert (env.sys.num_bodies, p.nc, p.lanes, p.wide) == (nb, nc, lanes, lanes > 32), scene
        assert (env.observation_size, env.action_size) == (obs, act), scene
        assert jenv.action_size == act, scene
        assert kernels.unsupported_features(env.sys, act) == [], scene
        if scene == "jump_cheetah":
            continue
        assert env.agent_names == jenv.agent_names
        assert env.group_action_shapes == jenv.group_action_shapes
        for name, meta in env.component_meta.items():
            jmeta = jenv.component_meta[name]
            for key in ("body_idx", "root_idx", "joint_dof_idx", "act_idx", "observers"):
                assert meta[key] == jmeta[key], (scene, name, key)

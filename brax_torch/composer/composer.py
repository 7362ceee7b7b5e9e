"""Scene composition: one physics system from component descriptions.

Counterpart of `brax_tpu/composer/composer.py`, batch-first:

    env = create(
        components=dict(
            agent1=dict(component='ant', pos=(0, 1, 0)),
            agent2=dict(component='ant', pos=(0, -1, 0)),
        ),
        edges={'agent1__agent2': dict(collide_type='root',
                                      reward_fns=dict(chase=dict(reward_type='chase')))},
        agent_groups=dict(agent1=dict(reward_names=('chase__agent1__agent2',)),
                          agent2=dict(reward_names=('chase__agent1__agent2',))),
        batch_size=4096)

`Composer` merges the components' namespaced configs into one scene
`Config`; `ComponentEnv` steps it (one PBD kernel launch per step on the
card, the twin on the CPU) with modular observations, rewards and
termination.  A multi-agent env's reward is (N, n_agents), one column per
agent group in name order; a single-agent env's is (N,).
"""

from __future__ import annotations

import copy
import itertools
from typing import Any, Dict, Optional

import numpy as np
import torch

from brax_torch import maths
from brax_torch.composer import components as components_lib
from brax_torch.composer import observers as observers_lib
from brax_torch.composer import reward_functions as rewards_lib
from brax_torch.envs import base
from brax_torch.sim import config as cfg


def _ns(comp_name: str, name: str) -> str:
    return f"{comp_name}/{name}"


class Composer:
    """Merges namespaced component configs into one scene Config."""

    def __init__(
        self,
        components: Dict[str, Dict[str, Any]],
        edges: Optional[Dict[str, Dict[str, Any]]] = None,
        add_ground: bool = True,
        agent_groups: Optional[Dict[str, Any]] = None,
        global_options: Optional[Dict[str, Any]] = None,
    ):
        components = copy.deepcopy(components)
        edges = copy.deepcopy(edges or {})
        global_options = dict(global_options or {})
        if add_ground:
            components["ground"] = dict(component="ground")

        self.agent_groups = agent_groups or {}

        # --- load + namespace components ---
        self.components: Dict[str, dict] = {}
        merged = cfg.Config(bodies=[], joints=[], actuators=[], forces=[])
        reward_descs = []  # (name, kind, factory_kwargs, comp names)

        for name in sorted(components):
            desc = dict(components[name])
            spec = components_lib.load_component(
                desc.pop("component"),
                **desc.pop("component_params", {}),
            )
            comp_cfg = copy.deepcopy(spec.config)
            rename = {}
            for b in comp_cfg.bodies:
                rename[b.name] = _ns(name, b.name)
                b.name = rename[b.name]
            for j in comp_cfg.joints:
                j.name = _ns(name, j.name)
                j.parent = rename[j.parent]
                j.child = rename[j.child]
            for a in comp_cfg.actuators:
                a.name = _ns(name, a.name)
                a.joint = _ns(name, a.joint)
            for fo in comp_cfg.forces:
                fo.name = _ns(name, fo.name)
                fo.body = rename[fo.body]
            comp_cfg.collide_include = [
                (rename[a], rename[b]) for a, b in comp_cfg.collide_include
            ]

            merged.bodies += comp_cfg.bodies
            merged.joints += comp_cfg.joints
            merged.actuators += comp_cfg.actuators
            merged.forces += comp_cfg.forces
            merged.collide_include += comp_cfg.collide_include
            for d in comp_cfg.defaults:
                for ang in d.angles:
                    ang.name = _ns(name, ang.name)
                for qps in d.qps:
                    qps.name = _ns(name, qps.name)
                if len(merged.defaults) == 0:
                    merged.defaults.append(cfg.Defaults())
                merged.defaults[0].angles += d.angles
                merged.defaults[0].qps += d.qps

            # term_params (z_offset for agents standing on objects, as in
            # ant_on_ball): shift the frame the component's termination
            # bounds are evaluated in
            term_fn = spec.term_fn
            term_params = desc.pop("term_params", None)
            if term_params and term_fn is not None:
                z_off = float(term_params.get("z_offset", 0.0))

                def term_fn(done, qp, root_idx, _f=spec.term_fn, _z=z_off):
                    shift = torch.tensor([0.0, 0.0, _z], device=qp.pos.device)
                    return _f(done, qp.replace(pos=qp.pos - shift), root_idx)

            comp = dict(
                name=name,
                root=_ns(name, spec.root),
                collides=[rename[c] for c in spec.collides],
                bodies=[b.name for b in comp_cfg.bodies],
                joints=[j.name for j in comp_cfg.joints],
                actuators=[a.name for a in comp_cfg.actuators],
                forces=[fo.name for fo in comp_cfg.forces],
                term_fn=term_fn,
                observers=list(desc.pop("observers", spec.observers)),
                pos=np.asarray(desc.pop("pos", (0.0, 0.0, 0.0)), np.float32),
                quat=np.asarray(desc.pop("quat", (1.0, 0.0, 0.0, 0.0)), np.float32),
                quat_origin=np.asarray(desc.pop("quat_origin", (0.0, 0.0, 0.0)), np.float32),
                frozen=desc.pop("frozen", False),
                # source config for dt defaults
                dt=comp_cfg.dt,
                substeps=comp_cfg.substeps,
                friction=comp_cfg.friction,
                elasticity=comp_cfg.elasticity,
                gravity=comp_cfg.gravity,
                angular_damping=comp_cfg.angular_damping,
                baumgarte_erp=comp_cfg.baumgarte_erp,
            )
            comp["collide"] = desc.pop("collide", True)
            if comp["frozen"]:
                for b in comp_cfg.bodies:
                    b.frozen = cfg.FrozenAxes(all=True)
            for rname, rkwargs in sorted(desc.pop("reward_fns", {}).items()):
                reward_descs.append((f"{rname}__{name}", "component", rkwargs, (name,)))
            assert not desc, f"unused component kwargs: {desc}"
            self.components[name] = comp

        # --- edges ---
        self.edge_observers = []  # (k1, k2, observer desc)
        for k1, k2 in itertools.combinations(sorted(self.components), 2):
            edge_name = f"{k1}__{k2}"
            v = edges.pop(edge_name, {})
            c1, c2 = self.components[k1], self.components[k2]
            collide_type = v.pop("collide_type", "full")
            if not (c1["collide"] and c2["collide"]):
                pass  # a collide=False endpoint suppresses the pair entirely
            elif collide_type == "full":
                merged.collide_include += [
                    (a, b) for a in c1["collides"] for b in c2["collides"]
                ]
            elif collide_type == "root":
                merged.collide_include += [(c1["root"], c2["root"])]
            elif collide_type:
                raise ValueError(f"unknown collide_type {collide_type}")
            for rname, rkwargs in sorted(v.pop("reward_fns", {}).items()):
                reward_descs.append(
                    (f"{rname}__{edge_name}", "edge", rkwargs, (k1, k2))
                )
            for obs_desc in v.pop("extra_observers", []):
                self.edge_observers.append((k1, k2, dict(obs_desc)))
            assert not v, f"unused edge kwargs: {v}"
        assert not edges, f"unknown edges: {sorted(edges)}"

        # --- global scene params ---
        ref = next(
            (c for c in self.components.values() if c["name"] != "ground"),
            next(iter(self.components.values())),
        )
        merged.dt = global_options.get("dt", ref["dt"])
        merged.substeps = global_options.get("substeps", ref["substeps"])
        merged.friction = global_options.get("friction", ref["friction"])
        merged.elasticity = global_options.get("elasticity", ref["elasticity"])
        merged.gravity = tuple(global_options.get("gravity", ref["gravity"]))
        merged.angular_damping = global_options.get(
            "angular_damping", ref["angular_damping"]
        )
        merged.baumgarte_erp = global_options.get(
            "baumgarte_erp", ref["baumgarte_erp"]
        )
        # '' lets validate() infer from joint stiffness: pure-PBD components
        # compose to pbd, spring components (octopus) to legacy_spring
        merged.dynamics_mode = global_options.get("dynamics_mode", "")

        self.config = merged
        self.reward_descs = reward_descs


class ComponentEnv(base.Env):
    """An Env over a composed scene: modular obs, rewards, termination."""

    def __init__(self, composer: Composer, batch_size: int = 1, device="cuda"):
        super().__init__(config=composer.config, batch_size=batch_size, device=device)
        self.composer = composer

        # resolve per-component indices against the built system
        body_index = self.art.body_index
        dof_offsets = {}
        off = 0
        for j in self.art.config.joints:
            dof_offsets[j.name] = list(range(off, off + len(j.angle_limits)))
            off += len(j.angle_limits)
        act_offsets = {}
        off = 0
        for a in self.art.config.actuators:
            dofs = len(
                next(j for j in self.art.config.joints if j.name == a.joint).angle_limits
            )
            act_offsets[a.name] = list(range(off, off + dofs))
            off += dofs
        # force action dims follow all actuator dofs, 3 per force
        # (sim/builder.py::_build_forces)
        force_offsets = {}
        for fo in self.art.config.forces:
            force_offsets[fo.name] = list(range(off, off + 3))
            off += 3

        self.component_meta = {}
        for name, comp in composer.components.items():
            meta = dict(comp)
            meta["body_idx"] = [body_index[b] for b in comp["bodies"]]
            meta["root_idx"] = body_index[comp["root"]]
            meta["joint_dof_idx"] = [
                i for j in comp["joints"] for i in dof_offsets[j]
            ]
            meta["act_idx"] = [
                i for a in comp["actuators"] for i in act_offsets[a]
            ] + [i for f in comp["forces"] for i in force_offsets[f]]
            self.component_meta[name] = meta

        # instantiate reward fns; track which components each touches (for
        # reward_agents group expansion)
        self.reward_fns = {}
        self._reward_comps = {}
        for rname, kind, rkwargs, comps in composer.reward_descs:
            rkwargs = dict(rkwargs)
            rtype = rkwargs.pop("reward_type")
            if kind == "component":
                fn = rewards_lib.COMPONENT_REWARDS[rtype](
                    self.component_meta[comps[0]], **rkwargs
                )
            else:
                fn = rewards_lib.EDGE_REWARDS[rtype](
                    self.component_meta[comps[0]],
                    self.component_meta[comps[1]],
                    **rkwargs,
                )
            self.reward_fns[rname] = fn
            self._reward_comps[rname] = tuple(comps)

        # multi-agent grouping: per-agent action slices + reward names.
        # reward_agents=('a',) expands to every reward touching component 'a'
        self.agent_groups = composer.agent_groups
        self.group_action_shapes = {}
        for agent, spec in sorted(self.agent_groups.items()):
            comps = spec.get("action_agents", (agent,))
            idx = [i for c in comps for i in self.component_meta[c]["act_idx"]]
            names = tuple(spec.get("reward_names", ()))
            for ragent in spec.get("reward_agents", ()):
                # exact component-set match ('a1' matches a1's own rewards,
                # ('a1', 'a2') matches the edge)
                rset = (ragent,) if isinstance(ragent, str) else tuple(sorted(ragent))
                names += tuple(
                    rn for rn, rcomps in self._reward_comps.items()
                    if tuple(sorted(rcomps)) == rset
                )
            names = tuple(dict.fromkeys(names))
            self.group_action_shapes[agent] = dict(
                indices=idx, size=len(idx), reward_names=names,
            )

    @property
    def is_multiagent(self) -> bool:
        return bool(self.agent_groups)

    @property
    def agent_names(self):
        return tuple(sorted(self.agent_groups))

    def reset(self, rng: Optional[torch.Generator] = None) -> base.State:
        """Every env of the batch at the scene's default state (the reset
        draws nothing, as the JAX env's does not)."""
        n = self.batch_size
        qpos = self.default_angle()
        qp = self.default_qp(joint_angle=qpos[None].expand(n, -1).contiguous())
        qp = self._transform_qp(qp)
        obs = self._get_obs(qp, self.sys.info(qp))
        zero = torch.zeros(n, device=self.device)
        reward = torch.zeros((n, len(self.agent_groups)), device=self.device) \
            if self.agent_groups else zero
        metrics = {f"reward_{k}": zero for k in self.reward_fns}
        metrics["distance"] = zero
        return base.State(qp, obs, reward, zero, metrics)

    def step(self, state: base.State, action: torch.Tensor) -> base.State:
        qp, info = self.sys.step(state.qp, action)
        obs = self._get_obs(qp, info)

        rewards, dones = {}, {}
        for name, fn in self.reward_fns.items():
            rewards[name], dones[name] = fn(self, qp, state.qp, action)
        zero = torch.zeros(action.shape[0], device=action.device)
        if self.agent_groups:
            per_agent = []
            for agent in self.agent_names:
                names = self.group_action_shapes[agent]["reward_names"]
                vals = [rewards[n] for n in names] or [zero]
                per_agent.append(sum(vals))
            reward = torch.stack(per_agent, dim=-1)
        else:
            reward = sum(rewards.values()) if rewards else zero

        # termination: any component term_fn or any reward-voted done
        # (caught prey, out of the ring)
        done = zero
        for meta in self.component_meta.values():
            if meta["term_fn"] is not None:
                done = meta["term_fn"](done, qp, meta["root_idx"])
        for d in dones.values():
            done = torch.maximum(done, d)

        metrics = dict(state.metrics, **{f"reward_{k}": v for k, v in rewards.items()})
        return state.replace(qp=qp, obs=obs, reward=reward, done=done, metrics=metrics)

    def _transform_qp(self, qp):
        """Applies each component's pos/quat placement."""
        pos, rot = qp.pos, qp.rot
        for meta in self.component_meta.values():
            # static skip: decided from the placement's values at build time
            if np.abs(meta["pos"]).sum() == 0.0 and float(meta["quat"][0]) == 1.0:
                continue
            t = lambda x: torch.as_tensor(x, device=pos.device)
            idx = meta["body_idx"]
            quat = t(meta["quat"]).expand(pos.shape[0], len(idx), 4)
            p = pos[:, idx]
            p = maths.rotate(p - t(meta["quat_origin"]), quat) + t(meta["quat_origin"])
            p = p + t(meta["pos"])
            r = maths.quat_mul(quat, rot[:, idx])
            pos, rot = pos.clone(), rot.clone()
            pos[:, idx] = p
            rot[:, idx] = r
        return qp.replace(pos=pos, rot=rot)

    def _get_obs(self, qp, info):
        entries = []
        for name in sorted(self.component_meta):
            entries += observers_lib.component_obs(
                self, self.component_meta[name], qp, info
            )
        for k1, k2, desc in self.composer.edge_observers:
            entries.append(
                observers_lib.edge_obs(
                    self, self.component_meta[k1], self.component_meta[k2],
                    desc, qp,
                )
            )
        self.observer_shapes = {k: tuple(v.shape[1:]) for k, v in entries}
        if not entries:
            return qp.pos.new_zeros((qp.pos.shape[0], 0))
        return torch.cat([v for _, v in entries], dim=-1)


def create(
    components: Dict[str, Dict[str, Any]],
    edges: Optional[Dict[str, Dict[str, Any]]] = None,
    add_ground: bool = True,
    agent_groups: Optional[Dict[str, Any]] = None,
    global_options: Optional[Dict[str, Any]] = None,
    episode_length: Optional[int] = 1000,
    action_repeat: int = 1,
    batch_size: Optional[int] = None,
    auto_reset: bool = True,
    device="cuda",
) -> base.Env:
    """Builds a composed environment with the standard wrapper stack: the
    episode wrapper, the (identity) vmap wrapper where a batch size is
    given, and auto-reset.  Without `batch_size` the env steps a batch of
    one."""
    from brax_torch.envs import wrappers

    env = ComponentEnv(
        Composer(
            components,
            edges=edges,
            add_ground=add_ground,
            agent_groups=agent_groups,
            global_options=global_options,
        ),
        batch_size=batch_size or 1,
        device=device,
    )
    if episode_length is not None:
        env = wrappers.EpisodeWrapper(env, episode_length, action_repeat)
    if batch_size:
        env = wrappers.VmapWrapper(env, batch_size)
    if auto_reset:
        env = wrappers.AutoResetWrapper(env)
    return env

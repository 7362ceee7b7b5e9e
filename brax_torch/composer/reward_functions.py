"""Reward-function library for composed scenes, batch-first.

Counterpart of `brax_tpu/composer/reward_functions.py`.  Each factory
returns `fn(env, qp, prev_qp, action) -> (reward, done)` over the whole
batch: qp holds (N, nb, C) tensors, action is (N, n_act), and reward and
done (this reward's termination vote: caught prey, pushed out of the ring)
are (N,).  Factories accept the common wrapper kwargs `scale`, `offset` and
`done_bonus`: raw reward r becomes `(r + offset) * scale`, plus
`done_bonus` where done fires.
"""

from __future__ import annotations

import torch


def _wrap(raw_fn, scale: float = 1.0, offset: float = 0.0, done_bonus: float = 0.0):
    def fn(env, qp, prev_qp, action):
        r, d = raw_fn(env, qp, prev_qp, action)
        r = (r + offset) * scale
        r = torch.where(d > 0, r + done_bonus, r)
        return r, d

    return fn


def _no_done(r):
    return r, torch.zeros_like(r)


def _dist_done(dist, min_dist: float, max_dist: float):
    done = torch.zeros_like(dist)
    done = torch.where(dist < min_dist, 1.0, done)
    return torch.where(dist > max_dist, 1.0, done)


def _root(qp_field, comp):
    return qp_field[:, comp["root_idx"]]


def _cols(t, indices):
    """Columns of t (N, k); an index past the end reads the last column, as
    the JAX package's gather clamps it (a sphericalized joint's padded dofs
    count in a component's action indices)."""
    return t[:, [min(int(i), t.shape[-1] - 1) for i in indices]]


def _full(qp, value):
    return torch.full(qp.pos.shape[:1], float(value), device=qp.pos.device)


# --- component rewards -------------------------------------------------------


def forward_velocity(comp: dict, weight: float = 1.0, axis: int = 0, **wrap_kw):
    """Velocity of the component root along an axis."""

    def raw(env, qp, prev_qp, action):
        dt = env.art.config.dt
        v = (_root(qp.pos, comp)[:, axis] - _root(prev_qp.pos, comp)[:, axis]) / dt
        return _no_done(weight * v)

    return _wrap(raw, **wrap_kw)


def alive_bonus(comp: dict, bonus: float = 1.0, **wrap_kw):
    def raw(env, qp, prev_qp, action):
        return _no_done(_full(qp, bonus))

    return _wrap(raw, **wrap_kw)


def ctrl_cost(comp: dict, weight: float = 0.5, **wrap_kw):
    """Negative sum-of-squares control cost over the component's actuators."""

    def raw(env, qp, prev_qp, action):
        return _no_done(-weight * torch.sum(torch.square(_cols(action, comp["act_idx"])), -1))

    return _wrap(raw, **wrap_kw)


def control_penalty(comp: dict, **wrap_kw):
    """Negative L2 norm of the component's action slice (ref control_reward)."""

    def raw(env, qp, prev_qp, action):
        return _no_done(-torch.linalg.norm(_cols(action, comp["act_idx"]), dim=-1))

    return _wrap(raw, **wrap_kw)


def constant(comp: dict, value: float = 1.0, **wrap_kw):
    def raw(env, qp, prev_qp, action):
        return _no_done(_full(qp, value))

    return _wrap(raw, **wrap_kw)


def root_goal(
    comp: dict,
    target_goal,
    sdcomp: str = "pos",
    indices=(0, 1, 2),
    min_dist: float = 0.0,
    max_dist: float = 1e8,
    **wrap_kw,
):
    """Negative distance of root pos/vel to a fixed target (ref root_goal)."""
    target = torch.as_tensor(target_goal, dtype=torch.float32)

    def raw(env, qp, prev_qp, action):
        field = qp.pos if sdcomp == "pos" else qp.vel
        cur = _cols(_root(field, comp), indices)
        dist = torch.linalg.norm(cur - target.to(cur.device), dim=-1)
        return -dist, _dist_done(dist, min_dist, max_dist)

    return _wrap(raw, **wrap_kw)


def norm_velocity(comp: dict, indices=(0, 1), **wrap_kw):
    """Negative planar speed of the root; scale=-s makes it a run bonus
    (ref ma_descs.get_run_reward / norm_reward of root vel)."""

    def raw(env, qp, prev_qp, action):
        return _no_done(-torch.linalg.norm(_cols(_root(qp.vel, comp), indices), dim=-1))

    return _wrap(raw, **wrap_kw)


# --- edge rewards ------------------------------------------------------------


def root_dist(
    comp_a: dict,
    comp_b: dict,
    min_dist: float = 0.0,
    max_dist: float = 1e8,
    indices=(0, 1, 2),
    **wrap_kw,
):
    """Negative root-to-root distance; done outside [min_dist, max_dist]
    (ref distance_reward: termination replaces clipping)."""

    def raw(env, qp, prev_qp, action):
        d = _cols(_root(qp.pos, comp_a), indices) - _cols(_root(qp.pos, comp_b), indices)
        dist = torch.linalg.norm(d, dim=-1)
        return -dist, _dist_done(dist, min_dist, max_dist)

    return _wrap(raw, **wrap_kw)


def distance(comp_a: dict, comp_b: dict, weight: float = 1.0, offset: float = 0.0,
             max_dist: float = 1e8, min_dist: float = 0.0):
    """Offset-minus-distance between roots (move-closer shaping)."""

    def fn(env, qp, prev_qp, action):
        d = torch.linalg.norm(_root(qp.pos, comp_a) - _root(qp.pos, comp_b), dim=-1)
        d = torch.clamp(d, min_dist, max_dist)
        return weight * (offset - d), torch.zeros_like(d)

    return fn


def chase(comp_a: dict, comp_b: dict, weight: float = 1.0):
    """Reward for closing the distance to b since the previous step."""

    def fn(env, qp, prev_qp, action):
        d = torch.linalg.norm(_root(qp.pos, comp_a) - _root(qp.pos, comp_b), dim=-1)
        d_prev = torch.linalg.norm(_root(prev_qp.pos, comp_a) - _root(prev_qp.pos, comp_b),
                                   dim=-1)
        return weight * (d_prev - d), torch.zeros_like(d)

    return fn


def exp_center_dist(
    comp_a: dict,
    comp_b: dict,
    which: str = "a",
    max_dist: float = 1e8,
    indices=(0, 1),
    **wrap_kw,
):
    """exp(-|root_xy|) of one endpoint; done when it leaves max_dist (the
    sumo ring reward, ref exp_norm_reward of root pos)."""
    comp = comp_a if which == "a" else comp_b

    def raw(env, qp, prev_qp, action):
        dist = torch.linalg.norm(_cols(_root(qp.pos, comp), indices), dim=-1)
        return torch.exp(-dist), _dist_done(dist, 0.0, max_dist)

    return _wrap(raw, **wrap_kw)


def direction(comp_a: dict, comp_b: dict, which: str = "a", indices=(0, 1),
              **wrap_kw):
    """Move-toward-opponent reward (ref direction_reward): when the mover
    heads at the target and the target is fleeing, reward the component of
    the mover's velocity along the target's (reversed) unit velocity."""
    mover, target = (comp_a, comp_b) if which == "a" else (comp_b, comp_a)

    def raw(env, qp, prev_qp, action):
        v0 = _cols(_root(qp.vel, mover), indices)
        v1 = _cols(_root(qp.vel, target), indices)
        p0 = _cols(_root(qp.pos, mover), indices)
        p1 = _cols(_root(qp.pos, target), indices)
        toward = torch.sum((p1 - p0) * v0, -1) > 0
        fleeing = torch.sum((p0 - p1) * v1, -1) > 0
        u1 = -v1 / (torch.linalg.norm(v1, dim=-1, keepdim=True) + 1e-8)
        r = torch.where(toward & fleeing, torch.sum(v0 * u1, -1), 0.0)
        return _no_done(torch.clamp(r, min=0.0))

    return _wrap(raw, **wrap_kw)


COMPONENT_REWARDS = {
    "forward_velocity": forward_velocity,
    "alive_bonus": alive_bonus,
    "ctrl_cost": ctrl_cost,
    "control_penalty": control_penalty,
    "constant": constant,
    "root_goal": root_goal,
    "norm_velocity": norm_velocity,
}
EDGE_REWARDS = {
    "distance": distance,
    "chase": chase,
    "root_dist": root_dist,
    "exp_center_dist": exp_center_dist,
    "direction": direction,
}

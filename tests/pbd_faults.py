"""Planted faults in the PBD kernel's capsule-capsule (two-way and
one-way), thruster/twister and angle-actuator (revolute and spherical)
sections and in its box-corner lanes (capsule-plane lanes of radius 0),
and what the parity rules (`brax_torch.tools.pbd_parity`) read on them.

Each fault is one textual change to `brax_torch/csrc/pbd_step.cu`'s
PBD_CAPCAP, PBD_CAPCAP_ONEWAY, PBD_FORCES, PBD_ANGLE or spherical actuator
code, made in a copy under the build directory:

- `b_sign`: body b's position update takes body a's sign;
- `no_b_gather`: no body gathers its side-b contacts (BODY_CON_B);
- `b_arm`: the velocity pass takes body a's lever arm for body b's;
- `b_mass`: the position pass' denominator takes body a's mass for body b's;
- `no_friction`: the capsule-capsule record's friction is read as 0;
- `thruster_sign`: a thruster pushes against its action;
- `force_body`: each body lane sums the forces of the next body;
- `reference_clip`: a force's columns are clipped at num_joint_dof +
  num_forces_dof - 1, as the Pallas body clips them, not to the action's
  width.  The inverted pendulums' thruster then reads its y and z columns
  from the next envs' actions and, in the last env, from past the action;
  their cart moves in x only, so what shows is what lies past the action:
  the emulation and the card's planted runs put NaNs there;
- `angle_degrees`: an angle actuator takes its action's degrees as radians;
- `angle_sign`: an angle actuator pushes with a torque actuator's sign;
- `twister_sign`: a twister turns against its action;
- `oneway_pushes_b`: a one-way capsule-capsule lane takes the two-way
  branch, which pushes body b back: body b's mass and inertia enter body
  a's update (the plan lists no one-way contact under body b, and grasp's
  body b is the frozen palm, so what shows is body a's update);
- `oneway_static_friction`: a one-way capsule-capsule lane holds static
  friction by the two-way test, |dlambdat| < |dlambda|, not |dlambdat| <
  |friction dlambda|;
- `spherical_angle_sign`: an angle actuator on a spherical joint pushes
  with a torque actuator's sign;
- `padded_reads_column_0`: a padded dof of a spherical joint's actuator
  (no action column) reads column 0 instead of acting as 0;
- `corner_radius`: a box corner's record (radius 0) is read with a
  capsule's radius, 0.05;
- `average_by_kg`: a body's position update is averaged over all PBD_KG
  contacts it gathers (fetch's lower legs: 8), not over those whose update
  is non-zero;
- `first_corner_only`: each body gathers only the first contact of its
  list (a lower leg its box's first corner);
- `box_two_way_sinking`: a box corner's lane restitutes by the two-way
  branch's test, v_n_old <= 0, not v_n_old <= -vel_threshold;
- `spring_hinge_sign`: a legacy-spring revolute joint's stiffness turns
  its child's hinge axis away from the parent's, not toward it;
- `universal_torque_sign`: a legacy-spring universal joint's torque that
  holds the child's y axis normal to the parent's x axis takes the other
  sign;
- `spring_count_all_groups`: a legacy-spring contact impulse is averaged
  over the non-zero impulses of its body in its group and in the groups
  before it, not in its group alone (halfcheetah's feet: the floor's group,
  then the feet's capsule-capsule pair);
- `spring_forces_twice`: a legacy-spring body adds its thrusters' and
  twisters' velocity changes twice;
- `wide_warp_local`: on the wide route (PBD_WIDE), a V3 exchange reads
  its source's lane within the reader's first warp (src % 32), as a
  warp's shuffle would: every contact, joint or body lane past lane 31
  hands its vector to the wrong lane;
- `wide_v3_swapped`: a V3 exchange hands back its y and z swapped;
- `wide_float_own_lane`: a float exchange reads the reader's own slot, not
  its source's (a body's contact counts are its own lane's).

`b_mass` and `no_friction` are planted in halfcheetah only: pusher's
capsule-capsule pairs have masses and inverse inertias of 1 on both sides
and a friction of 0 in its config, so there they change nothing.
`reference_clip` changes nothing in swimmer, whose action is as wide as
that clip.  grasp's frictions are all 1, where the two static-friction tests
agree, so `oneway_static_friction` is planted in `pusher_oneway` (pusher's
System with its capsule-capsule pairs made one-way, friction 0);
`padded_reads_column_0` in `grasp_padded` (grasp's System with dof 0's
column taken from every actuator but the first) and `twister_sign` in
`swimmer_twister` (swimmer with its torso's thruster made a twister):
Systems made for them (`pbd_parity.padded_grasp`, `oneway_pusher`,
`twister_swimmer`), as no default scene has what they change.  The box
faults are planted in fetch, from its states (`pbd_parity.fetch_states`);
the legacy-spring faults in the spring Systems of ant, humanoid_legacy,
halfcheetah (from its feet together, `pbd_parity.capcap_state`, where both
of a foot's groups act) and inverted_pendulum, named "<env>_spring", from
`pbd_parity.spring_states`.  The wide faults are planted in the
composer's 2- and 4-agent chase ("chase", "chase4": `pbd_parity.
COMPOSER_WIDE`), from `pbd_parity.composer_states`, and in octopus_run
(the wide route in legacy spring), from `pbd_parity.octopus_states`.

On the card,

    python -m tests.pbd_faults [scene ...]

holds this package's kernel and each planted one against the twin at
4096 envs of each scene (default: v1 halfcheetah, pusher,
inverted_pendulum, inverted_double_pendulum, swimmer, reacherangle, grasp,
fetch, the made scenes grasp_padded, pusher_oneway and swimmer_twister,
the spring Systems, the composer's chase and 4-agent chase and octopus_run),
from the states `chip_smoke.py` holds them in (a reset, 10 twin steps
after it and, for the capsule-capsule scenes, the pairs overlapping;
grasp's reset and its claw closed on the ball; fetch's reset and its feet
on the ground; its seeds), over one pass
and over the whole step, by the rounding rule and, for halfcheetah's and
pusher's pairs (two-way, and made one-way), the chaos rule.  It prints per scene,
state and kernel the outlier count of the rounding rule (with
`rounding_decided` of up to 16 outliers) and the stray count of the chaos
rule, then replays the state of `tests/test_torch_cuda.py`'s
`test_capcap_kernel_matches_twin_by_batch[4097-pusher]`, and prints the
card's name and power limit and a last line `RESULT {...}`.  These are the
readings CHAOS_SHARE and RULES are set from (PERF.md).  On the CPU,

    JAX_PLATFORMS=cpu python -m tests.pbd_faults --pallas-math

reads the same rules over one pass on the JAX package's Pallas kernel
body (`brax_tpu.sim.kernels._build_tile_step`, run eagerly), the reference
this kernel follows, against the twin at 4096 envs of halfcheetah from the
same three states (made here by the CPU's generator, so other draws): how
far a correct kernel in the Pallas order keeps to each rule.
`tests/test_torch_pbd_launch.py` runs the planted sources in the emulation
(`tests/pbd_emulation.py`).
"""

import json
import sys
import types
from pathlib import Path

import torch

from brax_torch.sim import kernels
from brax_torch.sim.types import QP
from brax_torch.tools import pbd_parity as pp

FAULTS = {
    "b_sign": ("V3 dpb = pimp * div_rn(-cs, cc.m_b);", "V3 dpb = pimp * div_rn(cs, cc.m_b);"),
    "no_b_gather": ("l.con_b[g][k] = __ldg(&BODY_CON_B[g][k][i]);", "l.con_b[g][k] = -1;"),
    "b_arm": ("V3 arm_b = cp.pos - pos_b;", "V3 arm_b = arm_a;"),
    "b_mass": ("float w2 = div_rn(1.0f, cc.m_b) + vdot(cr2, vmul(cr2, cc.ii_b));",
               "float w2 = div_rn(1.0f, cc.m_a) + vdot(cr2, vmul(cr2, cc.ii_b));"),
    "no_friction": ("cc.friction = capcap_f(CC_FRICTION, i);", "cc.friction = 0.0f;"),
    "thruster_sign": ("else bc.fvel = bc.fvel + d;", "else bc.fvel = bc.fvel - d;"),
    "force_body": ("const int f = __ldg(&BODY_FORCE[k][i]);",
                   "const int f = __ldg(&BODY_FORCE[k][(i + 1) % PBD_NB]);"),
    "reference_clip": ("const int last = n_act - 1;", "const int last = PBD_NJ + 3 * PBD_NF - 1;"),
    "angle_degrees": ("div_rn(ac.act * 3.14159265358979324f, 180.0f)", "ac.act"),
    "angle_sign": ("ts = -((target - angle) * ac.strength);",
                   "ts = (target - angle) * ac.strength;"),
    "twister_sign": ("if (__ldg(&FORCE_TWISTER[f])) bc.fang = bc.fang + d;",
                     "if (__ldg(&FORCE_TWISTER[f])) bc.fang = bc.fang - d;"),
    "oneway_pushes_b": ("cc.capcap = __ldg(&CONTACT_CAPCAP[i]) != 0;",
                        "cc.capcap = __ldg(&CONTACT_CAPCAP[i]) != 0 || __ldg(&CONTACT_ONEWAY[i]) != 0;"),
    "oneway_static_friction": ("fabsf(dlambdat) < fabsf(cc.friction * dlambda)",
                               "fabsf(dlambdat) < fabsf((cc.oneway ? 1.0f : cc.friction) * dlambda)"),
    "spherical_angle_sign": ("ts = -((target - angles[d]) * ac.strength);",
                             "ts = (target - angles[d]) * ac.strength;"),
    "padded_reads_column_0": (
        "ac.act[d] = (i < PBD_NA && col >= 0) ? in_act[e * n_act + col] : 0.0f;",
        "ac.act[d] = i < PBD_NA ? in_act[e * n_act + (col >= 0 ? col : 0)] : 0.0f;"),
    "corner_radius": ("cc.radius = contact_f(3, i);",
                      "cc.radius = contact_f(3, i) == 0.0f ? 0.05f : contact_f(3, i);"),
    "average_by_kg": ("float denom = 1e-6f + count;\n    dp = dp + acc_pos / denom;",
                      "float denom = 1e-6f + PBD_KG;\n    dp = dp + acc_pos / denom;"),
    "first_corner_only": ("l.con[g][k] = __ldg(&BODY_CON[g][k][i]);",
                          "l.con[g][k] = k == 0 ? __ldg(&BODY_CON[g][k][i]) : -1;"),
    "box_two_way_sinking": ("float sinking = v_n_old <= -vel_threshold ? 1.0f : 0.0f;",
                            "float sinking = v_n_old <= 0.0f ? 1.0f : 0.0f;"),
    "spring_hinge_sign": ("tq = vcross(a_p0, rotate(j.axis_c0, rot_c)) * j.stiffness;",
                          "tq = vcross(rotate(j.axis_c0, rot_c), a_p0) * j.stiffness;"),
    "universal_torque_sign": ("tq = vcross(proj, a_c1) * div_rn(j.limit_strength, 5.0f);",
                              "tq = vcross(a_c1, proj) * div_rn(j.limit_strength, 5.0f);"),
    "spring_count_all_groups": ("    count = 0.0f;  // each (group, body) its own average\n",
                                "    if (g == 0) count = 0.0f;\n"),
    "spring_forces_twice": ("  dang_a = dang_a + bc.fang;\n  dvel = dvel + bc.fvel;",
                            "  dang_a = dang_a + bc.fang + bc.fang;\n"
                            "  dvel = dvel + bc.fvel + bc.fvel;"),
    "wide_warp_local": ("return v3(pbd_xchg[0][src], pbd_xchg[1][src], pbd_xchg[2][src]);",
                        "return v3(pbd_xchg[0][src % 32], pbd_xchg[1][src % 32], "
                        "pbd_xchg[2][src % 32]);"),
    "wide_v3_swapped": ("return v3(pbd_xchg[0][src], pbd_xchg[1][src], pbd_xchg[2][src]);",
                        "return v3(pbd_xchg[0][src], pbd_xchg[2][src], pbd_xchg[1][src]);"),
    "wide_float_own_lane": ("  return pbd_xchg[0][src];\n",
                            "  return pbd_xchg[0][threadIdx.x];\n"),
}
# the scenes a fault changes anything in
FAULT_SCENES = {"b_sign": ("halfcheetah", "pusher"), "no_b_gather": ("halfcheetah", "pusher"),
                "b_arm": ("halfcheetah", "pusher"), "b_mass": ("halfcheetah",),
                "no_friction": ("halfcheetah",),
                "thruster_sign": ("inverted_pendulum", "swimmer"),
                "force_body": ("inverted_double_pendulum", "swimmer"),
                "reference_clip": ("inverted_pendulum", "inverted_double_pendulum"),
                "angle_degrees": ("reacherangle",), "angle_sign": ("reacherangle",),
                "twister_sign": ("swimmer_twister",), "oneway_pushes_b": ("grasp",),
                "oneway_static_friction": ("pusher_oneway",),
                "spherical_angle_sign": ("grasp",), "padded_reads_column_0": ("grasp_padded",),
                "corner_radius": ("fetch",), "average_by_kg": ("fetch",),
                "first_corner_only": ("fetch",), "box_two_way_sinking": ("fetch",),
                "spring_hinge_sign": ("ant_spring",),
                "universal_torque_sign": ("humanoid_legacy_spring",),
                "spring_count_all_groups": ("halfcheetah_spring",),
                "spring_forces_twice": ("inverted_pendulum_spring",),
                **{f: ("chase", "chase4", pp.OCTOPUS)
                   for f in ("wide_warp_local", "wide_v3_swapped", "wide_float_own_lane")}}
CAPCAP_SCENES = ("halfcheetah", "pusher")
FORCE_SCENES = ("inverted_pendulum", "inverted_double_pendulum", "swimmer", "reacherangle")
GRASP_SCENES = ("grasp", "grasp_padded")
# Systems made from a registered scene's (pbd_parity: oneway_pusher,
# padded_grasp, twister_swimmer): the scene they are made from, and how
MADE_SCENES = {"grasp_padded": ("grasp", pp.padded_grasp),
               "pusher_oneway": ("pusher", pp.oneway_pusher),
               "swimmer_twister": ("swimmer", lambda s: pp.twister_swimmer(s.mass.device))}
# the legacy-spring Systems the spring faults are planted in
SPRING_FAULT_SCENES = ("ant_spring", "humanoid_legacy_spring", "halfcheetah_spring",
                       "inverted_pendulum_spring")
# the composer's wide scenes (pbd_parity.COMPOSER_WIDE, and octopus_run:
# the wide route in legacy spring)
WIDE_SCENES = tuple(pp.COMPOSER_WIDE) + (pp.OCTOPUS,)
SCENES = (CAPCAP_SCENES + FORCE_SCENES + ("grasp", "fetch") + tuple(MADE_SCENES)
          + SPRING_FAULT_SCENES + WIDE_SCENES)
N = 4096


def scene_env(name, n, device):
    """The env of scene `name`: a spring one's ("<env>_spring") made with
    legacy_spring=True, a made scene's the registered one it is made from."""
    from brax_torch import envs

    if name.endswith("_spring"):
        return pp.spring_env(name[:-len("_spring")], n, device)
    if name in WIDE_SCENES:
        return pp.composer_env(name, n, device)
    return envs.create(MADE_SCENES.get(name, (name,))[0], episode_length=1000, batch_size=n,
                       device=device)


def spring_states(name, env, n, device, sys_=None):
    """A spring scene's states (`pbd_parity.spring_states`); halfcheetah's
    with its feet together in place of its reset (`pbd_parity.capcap_state`
    on the spring env), where both of a foot's contact groups act."""
    base = name[:-len("_spring")]
    out = pp.spring_states(base, env, n, 0, device, sys_)
    if base == "halfcheetah":
        out[pp.SPRING_STATES[0]] = pp.capcap_state(base, env, n, 1, device)
    return out


def scene_system(name, env):
    """The System of scene `name` on `env`, the env of the registered scene
    it is made from (MADE_SCENES) or of `name` itself."""
    return MADE_SCENES[name][1](env.sys) if name in MADE_SCENES else env.sys


def planted_text(fault: str) -> str:
    """pbd_step.cu's text with `fault` planted (its text must occur once)."""
    old, new = FAULTS[fault]
    text = kernels.SOURCE.read_text()
    assert text.count(old) == 1, (fault, text.count(old))
    return text.replace(old, new)


def planted_path(fault: str) -> Path:
    """A copy of pbd_step.cu with `fault` planted, under the build directory."""
    path = kernels.BUILD_DIR / "planted" / f"pbd_step_{fault}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(planted_text(fault))
    return path


def card_step(lib):
    """A kernel step (sys, qp, act) -> (qp, info) through library `lib`."""
    from brax_torch.tools import pbd_turns

    def step(sys_, qp, act):
        n, nb = qp.pos.shape[:2]
        # the action in a buffer with 16 NaNs past it: a planted fault that
        # reads past the action (reference_clip) reads them
        padded = torch.full((act.numel() + 16,), float("nan"), device=act.device)
        padded[:act.numel()] = act.reshape(-1)
        act = padded[:act.numel()].view(act.shape)
        ins = tuple(t.contiguous() for t in (qp.pos, qp.rot, qp.vel, qp.ang, act))
        outs = tuple(torch.empty((n, nb, c), device=qp.pos.device) for c in (3, 4, 3, 3, 3, 3))
        pbd_turns.launch(lib, ins, outs)
        contact = types.SimpleNamespace(vel=outs[4], ang=outs[5])
        return QP(*outs[:4]), types.SimpleNamespace(contact=contact)

    return step


def states(name, env, device, sys_=None):
    """chip_smoke.py's states of `name` at N envs, with its seeds: a
    capsule-capsule scene's three, a thruster or angle-actuator scene's two
    (`pbd_parity.force_scene_states`), grasp's two
    (`pbd_parity.grasp_states`), fetch's two (`pbd_parity.fetch_states`);
    `env` is the registered scene's (for a
    made scene, the one it is made from), whose twin steps run on `sys_`
    (default: env.sys)."""
    if name.endswith("_spring"):
        return spring_states(name, env, N, device, sys_)
    if name == pp.OCTOPUS:
        return pp.octopus_states(env, N, 0, device)
    if name in WIDE_SCENES:
        return pp.composer_states(name, env, N, 0, device)
    base = MADE_SCENES[name][0] if name in MADE_SCENES else name
    if base == "grasp":
        return pp.grasp_states(env.unwrapped, N, 0, device)
    if base == "fetch":
        return pp.fetch_states(env.unwrapped, N, 0, device)
    if base in FORCE_SCENES:
        return pp.force_scene_states(base, env, N, 0, device, sys_)
    sys_ = sys_ or env.sys
    gen = torch.Generator(device=device).manual_seed(0)
    act = lambda: torch.rand((N, env.action_size), generator=gen, device=device) * 2 - 1
    reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(sys_, settled, act())
    return dict(zip(pp.STATES, ((reset, act()), (settled, act()),
                                pp.capcap_state(base, env.unwrapped, N, 1, device))))


def reading(sys_, qp, act, step, spread, gen, decide_up_to):
    """Both rules' readings of one kernel from one state."""
    out, info = step(sys_, qp, act)
    got = pp.fields(out, info)
    r = pp.rounding_rule(sys_, qp, act, got, gen, decide_up_to)
    rec = {"outliers": len(r["outliers"]), "outlier_envs": r["outliers"].tolist()[:16],
           "decided": None if r["decided"] is None else int(r["decided"].sum()),
           "rounding_rule_passes": r["passes"], "max_abs_err_by_field": r["errs"]}
    if spread is not None:
        report, strays, allowed = pp.chaos_rule(sys_, qp, act, got, r["want"], spread=spread)
        rec.update(strays=len(strays), chaos_allowed=allowed,
                   chaos_rule_passes=len(strays) <= allowed)
    return rec


def pallas_math(name="halfcheetah"):
    """Both rules over one pass on the Pallas kernel body against the twin,
    on the CPU, per state; prints a line each and returns the readings."""
    import jax.numpy as jnp
    import numpy as np

    from brax_torch import envs
    from brax_tpu.envs import halfcheetah as jax_halfcheetah
    from brax_tpu.sim import kernels as jax_kernels

    env = envs.create(name, episode_length=1000, batch_size=N, device="cpu")
    sys_ = pp.one_pass(env.sys)
    tile_step = jax_kernels._build_tile_step(jax_halfcheetah.Halfcheetah().sys.replace(substeps=2))
    tile = lambda x: jnp.asarray(np.transpose(x.numpy(), (1, 2, 0)))

    def step(_, qp, act):
        outs = tile_step(tile(qp.pos), tile(qp.rot), tile(qp.vel), tile(qp.ang),
                         jnp.asarray(act.numpy().T))
        outs = [torch.from_numpy(np.transpose(np.asarray(o), (2, 0, 1)).copy()) for o in outs]
        return QP(*outs[:4]), types.SimpleNamespace(contact=types.SimpleNamespace(
            vel=outs[4], ang=outs[5]))

    result = {}
    for state, (qp, act) in states(name, env, "cpu").items():
        rec = reading(sys_, qp, act, step, pp.twin_spread(sys_, qp, act),
                      torch.Generator().manual_seed(7), 64)
        result[f"{name} | {state} | one pass | Pallas math"] = rec
        print(f"{name} | {state} | one pass | Pallas math (CPU): rounding rule {rec['outliers']} "
              f"outliers (decided {rec['decided']}); chaos rule strays {rec['strays']}; max err "
              f"{rec['max_abs_err_by_field']}", flush=True)
    print("RESULT " + json.dumps(result))
    return result


def main(argv):
    if argv[:1] == ["--pallas-math"]:
        return pallas_math()
    from brax_torch import cuda_build
    from brax_torch.tools import pbd_turns

    if not torch.cuda.is_available():
        sys.exit("tests.pbd_faults needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    card = cuda_build.card()
    print(card)
    scenes = {name: scene_env(name, N, device) for name in (argv or SCENES)}
    whole = {name: scene_system(name, e) for name, e in scenes.items()}
    systems = {(name, pass_): (pp.one_pass(whole[name]) if pass_ == "one pass" else whole[name])
               for name in scenes for pass_ in ("one pass", "whole step")}
    planted = {f: planted_path(f) for f in FAULTS}
    sources = {(key, f): pbd_turns.other_source(s, planted[f])
               for key, s in systems.items() for f in FAULTS if key[0] in FAULT_SCENES[f]}
    cuda_build.build(*(kernels.kernel_source(s) for s in systems.values()), *sources.values())
    result = {"card": card, "n_envs": N, "faults": {f: list(v) for f, v in FAULTS.items()},
              "max_outliers": pp.MAX_OUTLIERS, "chaos_share": pp.CHAOS_SHARE, "readings": {}}
    gen = torch.Generator(device=device).manual_seed(7)
    for name, env in scenes.items():
        for state, (qp, act) in states(name, env, device, whole[name]).items():
            for pass_ in ("one pass", "whole step"):
                sys_ = systems[name, pass_]
                # the chaos rule's readings for the chaotic capsule-capsule and
                # spring scenes
                chaotic = name in (CAPCAP_SCENES + ("pusher_oneway",) + SPRING_FAULT_SCENES
                                   + WIDE_SCENES)
                spread = pp.twin_spread(sys_, qp, act) if chaotic else None
                own = pp.twin_own_outside(sys_, qp, act, gen) if chaotic else None
                kernels_ = {"kernel": kernels.pbd_step,
                            **{f: card_step(pbd_turns.load(sources[(name, pass_), f]))
                               for f in FAULTS if name in FAULT_SCENES[f]}}
                for kname, step in kernels_.items():
                    rec = reading(sys_, qp, act, step, spread, gen,
                                  16 if kname == "kernel" else pp.MAX_OUTLIERS)
                    rec["twin_own_outside"] = own
                    result["readings"][f"{name} | {state} | {pass_} | {kname}"] = rec
                    print(f"{name} | {state} | {pass_} | {kname}: rounding rule "
                          f"{rec['outliers']} outliers (decided {rec['decided']}, passes "
                          f"{rec['rounding_rule_passes']}); chaos rule strays "
                          f"{rec.get('strays')} (passes {rec.get('chaos_rule_passes')}); the "
                          f"twin's own count {own}; max err {rec['max_abs_err_by_field']}",
                          flush=True)
    if "pusher" in scenes:
        # the card test's state: Scene(_config("pusher")), 4097 envs, capcap_state seed 0
        from tests.test_torch_pbd_launch import Scene, _config

        env = Scene(_config("pusher"), batch_size=4097, device=device)
        qp, act = pp.capcap_state("pusher", env, 4097, 0, device)
        for pass_, sys_ in (("whole step", env.sys), ("one pass", pp.one_pass(env.sys))):
            rec = reading(sys_, qp, act, kernels.pbd_step, pp.twin_spread(sys_, qp, act),
                          torch.Generator(device=device).manual_seed(7), 16)
            result["readings"][f"pusher 4097 card test | {pass_}"] = rec
            print(f"pusher 4097 card test | {pass_}: {rec}", flush=True)
    print(card)
    print("RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])

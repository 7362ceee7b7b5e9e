"""The rules that hold the v1 PBD kernel (`kernels.pbd_step`) to its plain
twin (`kernels.pbd_step_plain`) on the same inputs, the states of v1
halfcheetah and pusher whose two-way capsule-capsule pairs overlap, the
physics actions of the thruster and angle-actuator scenes and of hopper
and walker2d, grasp's states (its claw closed on the ball), fetch's (its
feet on the ground), the legacy-spring envs' states (`spring_states`),
the composer's wide scenes' states (`composer_states`: the 2- and 4-agent
chase, from a reset, after 10 twin steps and with the ants overlapping),
and Systems made for what no default scene has (a one-way pair whose body
b moves, padded spherical angle dofs, a twister).

`chip_smoke.py` and the tests (`tests/test_torch_cuda.py` on the card,
`tests/test_torch_pbd_launch.py` and `tests/test_torch_halfcheetah.py` on
the CPU) share them.  Two rules:

- the rounding rule (`max_errors`): every output of every env within
  TOLERANCE, except in at most MAX_OUTLIERS envs, each of which must be one
  whose result float rounding decides (`rounding_decided`);
- the chaos rule (`chaos_rule`): each env within CHAOS_RATIO x the twin's
  own spread under CHAOS_NOISE of input noise, in all but CHAOS_SHARE of
  the envs, for a chaotic step, where the twin itself leaves TOLERANCE in
  many envs under that noise.

The capsule-capsule scenes are held from each state over one PBD pass
(`one_pass`: the System with 2 substeps, what the kernel's loop repeats)
and over the whole 8- or 25-pass step, each by the rule RULES names.
CHAOS_SHARE and RULES come from readings of this kernel and of faults
planted in its capsule-capsule section (`tests/pbd_faults.py`, PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from brax_torch import maths
from brax_torch.sim import colliders, kernels

# the CPU parity tests' in-contact tolerances (tests/test_torch_step.py)
TOLERANCE = {"pos": 1e-4, "rot": 1e-4, "vel": 3e-3, "ang": 3e-3, "contact_vel": 3e-3,
             "contact_ang": 3e-3}
# an env outside TOLERANCE passes only if the twin, fed that env's input with
# relative noise of these sizes (about 1 and 8 float32 ulps), reproduces the
# kernel's output within TOLERANCE in at least one of PERTURBED_COPIES tries
ROUNDING_NOISE = (1e-7, 1e-6)
PERTURBED_COPIES = 64
# more outlier envs than this fails outright (chip_smoke.py's runs on an
# H100 at its seeds have shown 1 of 4096)
MAX_OUTLIERS = 4
# halfcheetah's joint angles with the back foot against the front foot,
# inside the joint limits: +-0.05 rad about them, 97% of 4096 draws overlap
FEET_TOGETHER = (-0.47, -0.73, -0.15, 0.55, 0.70, 0.10)
# the chaos rule: an env strays if some output is off by more than both
# TOLERANCE and CHAOS_RATIO x the twin's own spread over CHAOS_COPIES runs
# with relative input noise CHAOS_NOISE (about 8 float32 ulps); at most
# CHAOS_SHARE of the envs may stray.  Set between two readings at 4096 envs
# (tests/pbd_faults.py on an H100, PERF.md): a correct kernel has strayed
# in at most 39 envs (halfcheetah's whole step, its feet together), a
# planted capsule-capsule fault in at least 2129 with the pairs overlapping
CHAOS_NOISE = 1e-6
CHAOS_COPIES = 8
CHAOS_RATIO = 2.0
CHAOS_SHARE = 0.02
# the states the capsule-capsule scenes are held in, and the rule of each,
# (over one pass, over the whole step), chosen from the readings of
# tests/pbd_faults.py (PERF.md): the rounding rule wherever a correct kernel
# keeps to it at 4096 envs, the chaos rule where the twin itself leaves
# TOLERANCE in more than MAX_OUTLIERS envs under CHAOS_NOISE (halfcheetah
# but from a reset over one pass; pusher's whole step after 10 steps and
# with its pairs overlapping).  Over one pass, halfcheetah after 10 steps
# and with its feet together breaks the rounding rule in the JAX package's
# own Pallas kernel body too (3 and 28 envs outside TOLERANCE, 0 and 5 of
# them decided by rounding; `python -m tests.pbd_faults --pallas-math`)
STATES = ("reset", "after 10 twin steps", "capsule-capsule contact")
RULES = {
    "halfcheetah": {"reset": ("max_errors", "chaos_rule"),
                    "after 10 twin steps": ("chaos_rule", "chaos_rule"),
                    "capsule-capsule contact": ("chaos_rule", "chaos_rule")},
    "pusher": {"reset": ("max_errors", "max_errors"),
               "after 10 twin steps": ("max_errors", "chaos_rule"),
               "capsule-capsule contact": ("max_errors", "chaos_rule")},
    # pusher's pairs made one-way (oneway_pusher below), from the readings of
    # tests/pbd_faults.py at 4096 envs on an H100: with the pairs
    # overlapping the twin itself leaves TOLERANCE under CHAOS_NOISE in 79
    # envs over one pass and 104 over the whole step (the kernel: 48 and 34
    # outliers, 3 and 0 strays); after 10 steps its whole step has 5
    # rounding-decided outliers (the twin's own count 8, 1 stray)
    "pusher_oneway": {"reset": ("max_errors", "max_errors"),
                      "after 10 twin steps": ("max_errors", "chaos_rule"),
                      "capsule-capsule contact": ("chaos_rule", "chaos_rule")},
    # grasp (GRASP_STATES below): the rounding rule over one pass and the
    # whole step; its kernel kept every env within TOLERANCE of the twin in
    # the CPU emulation from both states
    "grasp": {"reset": ("max_errors", "max_errors"),
              "claw closed on the ball": ("max_errors", "max_errors")},
    # fetch (FETCH_STATES below), hopper and walker2d (a reset and 10 twin
    # steps after it): the rounding rule over one pass and the whole step.
    # Their kernels kept every env within TOLERANCE of the twin in the CPU
    # emulation; at 4096 envs on the CPU, fed its input with relative noise
    # of 1e-7, the twin itself left TOLERANCE in at most 1 env of a fetch
    # state, 2 of walker2d's reset (a contact's restitution test at the
    # velocity threshold) and none of hopper's, three draws each
    "fetch": {"reset": ("max_errors", "max_errors"),
              "feet on the ground": ("max_errors", "max_errors")},
    "hopper": {"reset": ("max_errors", "max_errors"),
               "after 10 twin steps": ("max_errors", "max_errors")},
    "walker2d": {"reset": ("max_errors", "max_errors"),
                 "after 10 twin steps": ("max_errors", "max_errors")},
    # legacy spring (SPRING_SCENES below; "<env>_spring", one substep and
    # the whole step): the chaos rule where the twin itself left TOLERANCE
    # in more than MAX_OUTLIERS of 4096 envs under CHAOS_NOISE in one of
    # three draws on the CPU (one substep / whole step): ant's reset 2-4 /
    # 4-11, after 10 steps 1-3 / 2-3; halfcheetah's 31-35 / 613-634 and
    # 2-5 / 476-497; humanoid_legacy's 85-105 / 90-103 and 1-2 / 9-12;
    # humanoidstandup's 1098-1128 / 150-161 and 2-4 / 9-14 (at reset each
    # contact sits exactly on the floor, so whether its impulse applies is
    # decided by the last bit); the scenes without contacts 0 / 0
    "ant_spring": {"reset": ("max_errors", "chaos_rule"),
                   "after 10 twin steps": ("max_errors", "max_errors")},
    "halfcheetah_spring": {"reset": ("chaos_rule", "chaos_rule"),
                           "after 10 twin steps": ("chaos_rule", "chaos_rule")},
    "humanoid_legacy_spring": {"reset": ("chaos_rule", "chaos_rule"),
                               "after 10 twin steps": ("max_errors", "chaos_rule")},
    "humanoidstandup_spring": {"reset": ("chaos_rule", "chaos_rule"),
                               "after 10 twin steps": ("max_errors", "chaos_rule")},
    **{f"{name}_spring": {"reset": ("max_errors", "max_errors"),
                          "after 10 twin steps": ("max_errors", "max_errors")}
       for name in ("inverted_pendulum", "inverted_double_pendulum", "reacher", "reacherangle")},
    # the composer's wide scenes (COMPOSER_WIDE below, PBD_WIDE): the chaos
    # rule where the twin itself left TOLERANCE in more than MAX_OUTLIERS
    # of 4096 envs under CHAOS_NOISE (composer_states' seed 0; one pass /
    # whole step, one draw on the CPU): the 2-agent chase's reset 8 / 7
    # (every foot on the floor to the last bit, as at legacy spring's
    # resets), after 10 steps 1 / 4 (at the limit), the ants overlapping
    # 2318 / 2377; the 4-agent chase's 10 / 17, 0 / 1 and 3223 / 3240.  On
    # an H100 (the card's draws) the 4-agent chase's whole step after 10
    # steps read 11, and its kernel 5 outliers: the chaos rule there too
    "chase": {"reset": ("chaos_rule", "chaos_rule"),
              "after 10 twin steps": ("max_errors", "chaos_rule"),
              "ants overlapping": ("chaos_rule", "chaos_rule")},
    "chase4": {"reset": ("chaos_rule", "chaos_rule"),
               "after 10 twin steps": ("max_errors", "chaos_rule"),
               "ants overlapping": ("chaos_rule", "chaos_rule")},
    # octopus_run (OCTOPUS_STATES below; the wide route in legacy spring,
    # one substep / the whole step): the twin itself left TOLERANCE under
    # CHAOS_NOISE in 4000-4002 / 1007-1034 of 4096 envs at the reset (every
    # tentacle tip on the floor to the last bit), 1 / 1-3 after 10 twin
    # steps and 0-2 / 3-4 from the jiggled state (three draws on the CPU,
    # octopus_states' seed 0): the chaos rule at the reset and over the
    # jiggled whole step (at MAX_OUTLIERS), the rounding rule elsewhere
    "octopus_run": {"reset": ("chaos_rule", "chaos_rule"),
                    "after 10 twin steps": ("max_errors", "max_errors"),
                    "jiggled": ("max_errors", "chaos_rule")},
    # biggym's new Systems (BIGGYM_SCENES below; one pass / the whole
    # step): the chaos rule where the twin itself left TOLERANCE under
    # CHAOS_NOISE in MAX_OUTLIERS or more of 4096 envs in one of three
    # draws on the CPU (biggym_states' seed 0), as the 2-agent chase's at
    # the limit: race_proant_ant's reset 0 / 0, after 10 steps 0-1 / 1-3;
    # chase_proant_ant's 0 / 0-1 and 0-2 / 1-3; sumo_proant_ant's 0 / 0-1
    # and 2-3 / 5-6; the race match's 5-9 / 6-10 and 0-2 / 2-4; the sumo
    # match's 8-10 / 10-11 and 0-1 / 1-4; the onigokko match's 0 / 0-1 and
    # 0-1 / 2-4 (a reset draws nothing: its 4096 envs are one state)
    "race_proant_ant": {"reset": ("max_errors", "max_errors"),
                        "after 10 twin steps": ("max_errors", "max_errors")},
    "chase_proant_ant": {"reset": ("max_errors", "max_errors"),
                         "after 10 twin steps": ("max_errors", "max_errors")},
    "sumo_proant_ant": {"reset": ("max_errors", "max_errors"),
                        "after 10 twin steps": ("max_errors", "chaos_rule")},
    "match_race_ma__ant_ant__proant_ant": {"reset": ("chaos_rule", "chaos_rule"),
                                           "after 10 twin steps": ("max_errors", "chaos_rule")},
    "match_sumo__ant_ant__proant_ant": {"reset": ("chaos_rule", "chaos_rule"),
                                        "after 10 twin steps": ("max_errors", "chaos_rule")},
    "match_onigokko_prey__proant_ant__ant_ant": {
        "reset": ("max_errors", "max_errors"),
        "after 10 twin steps": ("max_errors", "chaos_rule")},
}


def fields(qp, info):
    return {"pos": qp.pos, "rot": qp.rot, "vel": qp.vel, "ang": qp.ang,
            "contact_vel": info.contact.vel, "contact_ang": info.contact.ang}


def per_env_errors(a, b):
    """{field: (N,) max abs error per env} between two `fields` dicts."""
    return {k: (a[k] - b[k]).abs().amax(dim=(1, 2)) for k in TOLERANCE}


# the twin's steps of the last few inputs (twin_step)
_TWIN_STEPS = []
TWIN_STEPS_KEPT = 4


def twin_step(sys_, qp, act):
    """kernels.pbd_step_plain(sys_, qp, act), remembered for the last
    TWIN_STEPS_KEPT inputs, by identity (no check changes a state in
    place): a state's checks (its contact share, the twin's own spread,
    the rule's reference) read the twin's step of the same inputs up to
    four times, and at 4096 envs one step of a contact scene takes the
    card's host 0.1-1.5 s."""
    for s, q, a, out in _TWIN_STEPS:
        if s is sys_ and q is qp and a is act:
            return out
    out = kernels.pbd_step_plain(sys_, qp, act)
    _TWIN_STEPS.insert(0, (sys_, qp, act, out))
    del _TWIN_STEPS[TWIN_STEPS_KEPT:]
    return out


def one_pass(sys_):
    """The System stepped over one PBD pass (2 substeps), or one substep in
    legacy spring: what the kernel's loop repeats, so rounding differences
    are not carried into the next pass."""
    return dataclasses.replace(sys_, substeps=1 if sys_.dynamics_mode == "legacy_spring" else 2)


def rounding_decided(sys_, qp, act, idx, kernel_out, gen):
    """Which outlier envs the twin itself reaches from rounding-level noise.

    Each env of `idx` is copied PERTURBED_COPIES times, every input component
    scaled by (1 + s * u) with u uniform in [-1, 1] and s from ROUNDING_NOISE,
    and stepped by the twin.  An env counts as decided by rounding (a contact
    threshold that float rounding puts on one side or the other) when some
    copy lands within TOLERANCE of the kernel's output on every field.
    Returns a (len(idx),) bool tensor.
    """
    k = PERTURBED_COPIES
    scale = torch.tensor(ROUNDING_NOISE, device=qp.pos.device).repeat(k // len(ROUNDING_NOISE))

    def noisy(x):
        rep = x[idx].repeat_interleave(k, dim=0)
        u = torch.rand(rep.shape, generator=gen, device=rep.device) * 2 - 1
        return rep * (1 + scale.repeat(len(idx))[:, None, None] * u)

    pqp = type(qp)(pos=noisy(qp.pos), rot=noisy(qp.rot), vel=noisy(qp.vel), ang=noisy(qp.ang))
    pout, pinfo = kernels.pbd_step_plain(sys_, pqp, act[idx].repeat_interleave(k, dim=0))
    want = {f: v[idx].repeat_interleave(k, dim=0) for f, v in kernel_out.items()}
    errs = per_env_errors(fields(pout, pinfo), want)
    ok = torch.stack([errs[f] <= TOLERANCE[f] for f in TOLERANCE]).all(dim=0)
    return ok.reshape(len(idx), k).any(dim=1)


def rounding_rule(sys_, qp, act, got, gen, decide_up_to=MAX_OUTLIERS):
    """The rounding rule's reading of a kernel output `got` (a `fields`
    dict of one step from qp, act), without a verdict: {"errs": {field:
    max abs error}, "inside": {field: max abs error over the envs within
    TOLERANCE}, "within": {field: envs within it}, "outliers": indices of
    the envs outside it, "decided": rounding_decided of them (None when
    there are none or more than `decide_up_to`), "passes": the rule's
    verdict, "want": the twin's}."""
    want = fields(*twin_step(sys_, qp, act))
    per_env = per_env_errors(got, want)
    over = torch.stack([~(e <= TOLERANCE[k]) for k, e in per_env.items()]).any(dim=0)
    idx = over.nonzero().flatten()
    inside = {k: float(e[~over].max()) if bool((~over).any()) else float("nan")
              for k, e in per_env.items()}
    decided = (rounding_decided(sys_, qp, act, idx, got, gen)
               if 0 < len(idx) <= decide_up_to else None)
    passes = len(idx) <= MAX_OUTLIERS and (decided is None or bool(decided.all()))
    return {"errs": {k: float(e.max()) for k, e in per_env.items()}, "inside": inside,
            "within": {k: int((e <= TOLERANCE[k]).sum()) for k, e in per_env.items()},
            "outliers": idx, "decided": decided, "passes": passes, "want": want}


def max_errors(sys_, qp, act, gen, label=""):
    """Kernel vs twin from one state, by the rounding rule.

    Returns ({field: max abs error over all envs}, {field: max abs error
    over the envs within TOLERANCE on every field}, outlier count).  Every
    field of every env must be within TOLERANCE, except in at most
    MAX_OUTLIERS envs, each of which must be one whose result float
    rounding decides (rounding_decided): the kernel computes in the order
    of the Pallas kernel it replaces, the twin in the order of the JAX jnp
    path, and near a contact threshold that order picks the branch.
    scripts/replay_outliers.py replays such envs through both JAX paths,
    which split on them the same way.
    """
    out, info = kernels.pbd_step(sys_, qp, act)
    r = rounding_rule(sys_, qp, act, fields(out, info), gen)
    n = qp.pos.shape[0]
    idx = r["outliers"]
    for k in TOLERANCE:
        print(f"parity {label}{k}: max|kernel - twin| = {r['errs'][k]:.3e} over all envs, "
              f"{r['inside'][k]:.3e} over the {n - len(idx)} envs within tolerance "
              f"(tolerance {TOLERANCE[k]:.0e}; this field within it in "
              f"{r['within'][k]}/{n} envs)")
    outliers = len(idx)
    print(f"parity {label}: {outliers} outlier envs of {n}: {idx.tolist()[:16]}")
    if outliers > MAX_OUTLIERS:
        raise AssertionError(f"kernel disagrees with its plain twin in {outliers} envs "
                             f"(at most {MAX_OUTLIERS} allowed): {r['errs']}")
    if outliers:
        # inputs and both outputs of the outliers, for scripts/replay_outliers.py
        path = kernels.BUILD_DIR / "parity_outliers.npz"
        host = lambda x: x[idx].cpu().numpy()
        np.savez(path, pos=host(qp.pos), rot=host(qp.rot), vel=host(qp.vel),
                 ang=host(qp.ang), act=host(act), kernel_vel=host(out.vel),
                 twin_vel=host(r["want"]["vel"]), kernel_contact_ang=host(info.contact.ang),
                 twin_contact_ang=host(r["want"]["contact_ang"]))
        print(f"parity: outlier inputs saved to {path}")
        decided = r["decided"]
        print(f"parity: the twin reproduces the kernel from input noise of relative size "
              f"{ROUNDING_NOISE} in {int(decided.sum())}/{outliers} outlier envs")
        if not bool(decided.all()):
            raise AssertionError(f"kernel disagrees with its plain twin in envs "
                                 f"{idx[~decided].tolist()}, beyond rounding: {r['errs']}")
    return r["errs"], r["inside"], outliers


def twin_spread(sys_, qp, act, seed=7):
    """{field: (N,) the twin's own spread per env}: each env stepped by the
    twin CHAOS_COPIES more times, its input scaled by (1 + CHAOS_NOISE u),
    u uniform in [-1, 1] (about 8 float32 ulps); the farthest a copy lands
    from the twin's own output."""
    n, k = qp.pos.shape[0], CHAOS_COPIES
    gen = torch.Generator(device=qp.pos.device).manual_seed(seed)

    def noisy(x):
        rep = x.repeat_interleave(k, dim=0)
        return rep * (1 + CHAOS_NOISE * (torch.rand(rep.shape, generator=gen,
                                                     device=x.device) * 2 - 1))

    base = fields(*twin_step(sys_, qp, act))
    copies = fields(*kernels.pbd_step_plain(
        sys_, type(qp)(*(noisy(x) for x in (qp.pos, qp.rot, qp.vel, qp.ang))),
        act.repeat_interleave(k, dim=0)))
    return {f: (copies[f] - base[f].repeat_interleave(k, dim=0)).abs().flatten(1).amax(dim=1)
            .reshape(n, k).amax(dim=1) for f in TOLERANCE}


def chaos_rule(sys_, qp, act, got, want, tol=TOLERANCE, seed=7, spread=None):
    """Which envs of `got` stray from `want` (fields dicts of one step from
    qp, act) beyond the twin's own rounding spread there (`twin_spread`,
    or `spread` where given).

    An env strays if in some field |got - want| exceeds both that field's
    `tol` and CHAOS_RATIO x its spread, or is not finite (a NaN or an
    infinity in either output: no spread covers it).  Returns ({field:
    report}, straying env indices, the most that may stray: CHAOS_SHARE of
    the envs, rounded down).

    halfcheetah's step is chaotic: its feet (inverse inertia ~150) spin at
    up to ~330 rad/s at reset and contact tests (static friction, a closing
    velocity <= 0) flip on the last bit, so 1e-7 of input noise moves the
    twin itself outside TOLERANCE's angular fields in 11-25% of envs, and
    the Pallas kernel's math and the JAX jnp path, two orders of the same
    arithmetic, disagree as often (measured on the CPU at 256-512 envs from
    a reset, after 10 steps and with the feet together).  No per-env
    tolerance holds there: this rule holds each env to the twin's own
    spread, which is at rounding level in the envs that are not chaotic."""
    n = qp.pos.shape[0]
    spread = spread or twin_spread(sys_, qp, act, seed)
    report, strays = {}, torch.zeros(n, dtype=torch.bool, device=qp.pos.device)
    for f in tol:
        err = (got[f] - want[f]).abs().flatten(1).amax(dim=1)
        beyond = ((err > tol[f]) & (err > CHAOS_RATIO * spread[f])) | ~torch.isfinite(err)
        strays |= beyond
        report[f] = {"outside": int((~(err <= tol[f])).sum()),
                     "spread_outside": int((spread[f] > tol[f]).sum()),
                     "beyond_spread": int(beyond.sum()), "max": float(err.max())}
    return report, strays.nonzero().flatten(), int(CHAOS_SHARE * n)


def chaos_errors(sys_, qp, act, label):
    """Kernel vs twin from one state of a chaotic step, by chaos_rule;
    raises if more envs stray than it allows.  Returns its report."""
    out, info = kernels.pbd_step(sys_, qp, act)
    report, strays, allowed = chaos_rule(sys_, qp, act, fields(out, info),
                                         fields(*twin_step(sys_, qp, act)))
    n = qp.pos.shape[0]
    for k, r in report.items():
        print(f"parity {label}{k} (chaos rule): {r['outside']} envs of {n} outside the tolerance "
              f"{TOLERANCE[k]:.0e}, {r['beyond_spread']} of them beyond {CHAOS_RATIO:g}x the "
              f"twin's own spread ({r['spread_outside']} envs whose spread exceeds the "
              f"tolerance); max|kernel - twin| {r['max']:.3e}")
    print(f"parity {label}(chaos rule): {len(strays)} envs stray, at most {allowed} may: "
          f"{strays.tolist()[:16]}")
    if len(strays) > allowed:
        raise AssertionError(f"kernel strays from its twin beyond the twin's own rounding spread "
                             f"in {len(strays)} envs (at most {allowed}): {report}")
    return {**report, "strays": len(strays), "allowed": allowed}


def twin_own_outside(sys_, qp, act, gen):
    """Envs in which the twin, fed its input with relative noise
    CHAOS_NOISE, leaves TOLERANCE of its own output (one draw): how chaotic
    the step is there.  Read out beside the rules; it picks none."""
    noisy = lambda x: x * (1 + CHAOS_NOISE * (torch.rand(x.shape, generator=gen,
                                                         device=x.device) * 2 - 1))
    base = fields(*twin_step(sys_, qp, act))
    moved = fields(*kernels.pbd_step_plain(
        sys_, type(qp)(*(noisy(x) for x in (qp.pos, qp.rot, qp.vel, qp.ang))), act))
    errs = per_env_errors(moved, base)
    return int(torch.stack([errs[k] > TOLERANCE[k] for k in TOLERANCE]).any(dim=0).sum())


def hold(rule, sys_, qp, act, gen, label):
    """The kernel against the twin from one state by `rule` ("max_errors"
    or "chaos_rule"); raises where it fails.  Returns the record."""
    if rule == "chaos_rule":
        report = chaos_errors(sys_, qp, act, label)
        return {"rule": rule, "chaos_rule": report,
                "max_abs_err_by_field": {k: report[k]["max"] for k in TOLERANCE}}
    errs, inside, outliers = max_errors(sys_, qp, act, gen, label)
    return {"rule": rule, "max_abs_err_by_field": errs,
            "max_abs_err_within_tolerance_by_field": inside,
            "outlier_envs_decided_by_rounding": outliers}


def hold_capcap(name, state, sys_, qp, act, gen, label):
    """A scene's kernel (the capsule-capsule scenes halfcheetah, pusher and
    grasp; fetch, hopper and walker2d; the spring scenes, "<env>_spring")
    against the twin from one state, over one pass (a spring scene's one
    substep) and over the whole step, each by the rule RULES names.  Raises
    where a rule fails; returns the record."""
    one, whole = RULES[name][state]
    own = twin_own_outside(sys_, qp, act, gen)
    print(f"parity {label}: the twin leaves the tolerance in {own} envs of {qp.pos.shape[0]} "
          f"under {CHAOS_NOISE:.0e} input noise (whole step); one pass by {one}, the whole "
          f"step by {whole}")
    return {**hold(whole, sys_, qp, act, gen, label), "twin_own_outside": own,
            "one_pass": hold(one, one_pass(sys_), qp, act, gen, f"{label}one pass ")}


def contact_share(sys_, qp, act):
    """The share of envs with a contact impulse in the twin's step."""
    _, info = twin_step(sys_, qp, act)
    return float((info.contact.vel.abs().amax(dim=(1, 2)) > 0).float().mean())


def object_on_arm(sys_, qp, gen):
    """qp with each env's body b of a two-way capsule-capsule pair (pusher's
    object) moved onto body a's capsule of a pair drawn per env: its
    capsule's centre at a random point of that segment, 0.3-0.9 of the two
    radii away in a random direction, so that the pair overlaps."""
    g = next(c for c in sys_.contact_groups if isinstance(c, colliders.CapsuleCapsule))
    n, device = qp.pos.shape[0], qp.pos.device
    rand = lambda *shape: torch.rand(shape, generator=gen, device=device)
    pair = torch.randint(0, len(g.com.body_a), (n,), generator=gen, device=device)
    rows = torch.arange(n, device=device)
    a = torch.as_tensor(g.com.body_a, device=device)[pair]
    b = torch.as_tensor(g.com.body_b, device=device)[pair]
    on_a = maths.rotate(g.off_a[pair] + g.end_a[pair] * (2 * rand(n, 1) - 1), qp.rot[rows, a])
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    reach = (g.radius_a[pair] + g.radius_b[pair])[:, None] * (0.3 + 0.6 * rand(n, 1))
    pos = qp.pos.clone()
    pos[rows, b] = (qp.pos[rows, a] + on_a + d * reach
                    - maths.rotate(g.off_b[pair], qp.rot[rows, b]))
    return type(qp)(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)


def capcap_state(name, env, n, seed, device):
    """n states of halfcheetah or pusher with their two-way capsule-capsule
    pairs in contact, and an action: halfcheetah's feet together
    (FEET_TOGETHER +- 0.05 rad), pusher's object on its arm (object_on_arm);
    joint velocities in +-0.1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nd = env.sys.num_joint_dof
    uniform = lambda scale, cols: (torch.rand((n, cols), generator=gen, device=device) * 2
                                   - 1) * scale
    if name == "halfcheetah":
        angle = torch.tensor(FEET_TOGETHER, device=device) + uniform(0.05, nd)
    else:
        angle = env.default_angle() + uniform(0.1, nd)
    qp = env.default_qp(joint_angle=angle, joint_velocity=uniform(0.1, nd))
    if name == "pusher":
        qp = object_on_arm(env.sys, qp, gen)
    return qp, uniform(1.0, env.action_size)


def capcap_share(sys_, qp):
    """The share of envs with a two-way capsule-capsule pair overlapping."""
    pens = [g.contact(qp.take(g.com.body_a), qp.take(g.com.body_b)).penetration
            for g in sys_.contact_groups if isinstance(g, colliders.CapsuleCapsule)]
    return float((torch.cat([p.flatten(1) for p in pens], dim=1) > 0).any(dim=1).float().mean())


# the scenes held from a reset and 10 twin steps after it: those without
# contacts (thrusters: the inverted pendulums, swimmer; angle actuators:
# reacherangle; reacher) and hopper and walker2d (one-way capsule-plane
# contacts), and the width of each one's physics action: the env's, and
# swimmer's 9 viscosity columns after its 2
PHYSICS_ACT = {"inverted_pendulum": 1, "inverted_double_pendulum": 1, "swimmer": 11,
               "reacherangle": 2, "reacher": 2, "hopper": 3, "walker2d": 6}


def physics_actions(name, n, gen, device):
    """(n, PHYSICS_ACT[name]) physics actions, uniform in [-1, 1];
    reacherangle's in degrees, +-300, past its joints' +-180 degree limits,
    so that the target's clip acts; swimmer's viscosity columns +-5, the
    drag's clip."""
    act = torch.rand((n, PHYSICS_ACT[name]), generator=gen, device=device) * 2 - 1
    if name == "reacherangle":
        act = act * 300.0
    if name == "swimmer":
        act = torch.cat([act[:, :2], act[:, 2:] * 5.0], dim=-1)
    return act


def force_scene_states(name, env, n, seed, device, sys_=None):
    """{state: (qp, act)} of a scene of PHYSICS_ACT at n envs: a reset of
    `env` and 10 twin steps after it (of `sys_`, default env.sys) on
    `physics_actions`, each with one more action."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = lambda: physics_actions(name, n, gen, device)
    reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(sys_ or env.sys, settled, act())
    return {STATES[0]: (reset, act()), STATES[1]: (settled, act())}


# grasp: its states, reset and the claw closed on the ball (all four
# fingertips on it after GRASP_CLOSE_STEPS twin steps of the closing action
# in 100% of 64 CPU draws; the proximal joints swing in over ~15 steps)
GRASP_STATES = ("reset", "claw closed on the ball")
GRASP_CLOSE_STEPS = 17
GRASP_NOISE = 0.1


def claw_closing_action(env, n, gen, device):
    """(n, 39) env actions of grasp (`env` unwrapped) that close the claw on
    the ball: every finger's curl (dof 0 of the middle and distal joints) and
    swing (dof 0 of the proximal joint) at the limit that turns it inward
    (the first finger's lower limit, the others' upper one), the other dofs
    at mid-range and the palm's target at (0, 0, 3.5), just above it; plus
    uniform noise of +-GRASP_NOISE, clipped to [-1, 1]."""
    a = torch.zeros(env.action_size, device=device)
    for j, joint in enumerate(env.art.config.joints):
        a[3 * j] = -1.0 if j < 3 else 1.0
    a[-3:] = torch.tensor([0.0, 0.0, -1.0], device=device)
    noise = (torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1)
    return (a + GRASP_NOISE * noise).clamp(-1.0, 1.0)


def grasp_states(env, n, seed, device):
    """{state: (qp, act)} of grasp (`env` unwrapped, n envs) as its physics
    step is given them (`env.physics_input`: the palm moved, the action
    mapped onto the joints' limits in degrees and the palm's box): from a
    reset on uniform actions in [-1, 1], and with the claw closed on the
    ball (GRASP_CLOSE_STEPS twin steps of `claw_closing_action`), on one
    more closing action."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qp = env.reset(gen).qp
    rand = torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    states = {GRASP_STATES[0]: env.physics_input(qp, rand)}
    for _ in range(GRASP_CLOSE_STEPS):
        qp, _ = kernels.pbd_step_plain(env.sys, *env.physics_input(
            qp, claw_closing_action(env, n, gen, device)))
    states[GRASP_STATES[1]] = env.physics_input(qp, claw_closing_action(env, n, gen, device))
    return states


# fetch: its states, a reset and its feet on the ground (each env holding a
# small torque of +-FETCH_HOLD for FETCH_SETTLE_STEPS twin steps: 2-4 corners
# of a lower leg's box on the ground, ~1e-4 deep, in 97.6% of the legs of 1024
# CPU draws; the reset has none below it)
FETCH_STATES = ("reset", "feet on the ground")
FETCH_SETTLE_STEPS = 15
FETCH_HOLD = 0.02


def fetch_states(env, n, seed, device):
    """{state: (qp, act)} of fetch (`env` unwrapped, n envs): from a reset
    (every box corner of the lower legs exactly on the ground, as
    `default_qp` lifts the tree: the corners are pushed by the first
    half-substep's fall, not by rounding) on uniform actions in [-1, 1], and
    with its feet on the ground after FETCH_SETTLE_STEPS twin steps of an
    action of +-FETCH_HOLD per env, on that action again."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qp = env.reset(gen).qp
    rand = lambda scale: (torch.rand((n, env.action_size), generator=gen, device=device) * 2
                          - 1) * scale
    states = {FETCH_STATES[0]: (qp, rand(1.0))}
    hold = rand(FETCH_HOLD)
    for _ in range(FETCH_SETTLE_STEPS):
        qp, _ = kernels.pbd_step_plain(env.sys, qp, hold)
    states[FETCH_STATES[1]] = (qp, hold)
    return states


def corners_down(env, qp):
    """(n, legs) the box corners of each lower leg of fetch below the ground."""
    (g,) = env.sys.contact_groups
    pen = g.contact(qp.take(g.com.body_a), qp.take(g.com.body_b)).penetration
    return (pen > 0).sum(dim=-1)


def fingertips_on_ball(env, qp):
    """The share of grasp envs with all four fingertips on the ball."""
    g = next(c for c in env.sys.contact_groups
             if isinstance(c, colliders.CapsuleCapsule) and not c.com.one_way)
    pen = g.contact(qp.take(g.com.body_a), qp.take(g.com.body_b)).penetration.flatten(1)
    return float((pen > 0).all(dim=1).float().mean())


# Systems made to reach what no default scene has
def oneway_pusher(sys_):
    """pusher's System with its capsule-capsule pairs made one-way: a
    one-way capsule-capsule group whose body b (the object) moves, which
    grasp's (body b the frozen palm) cannot show: only body a may move."""
    groups = tuple(dataclasses.replace(c, com=dataclasses.replace(c.com, one_way=True))
                   if isinstance(c, colliders.CapsuleCapsule) else c
                   for c in sys_.contact_groups)
    return dataclasses.replace(sys_, contact_groups=groups)


def padded_grasp(sys_):
    """grasp's System with dof 0's action column taken from every actuator
    but the first (-1, a padded dof): each such dof PDs toward clip(0, lo,
    hi), not toward its action; with limits of (0, 90), (-90, 0) or (-45,
    45) degrees, reading any column there would move it."""
    (group,) = sys_.actuator_groups
    act_index = group.act_index.copy()
    act_index[1:, 0] = -1
    return dataclasses.replace(sys_, actuator_groups=(
        dataclasses.replace(group, act_index=act_index),))


def twister_swimmer(device):
    """swimmer's System with its torso's thruster made a twister (three
    action columns of angular velocity change): no default scene has one."""
    from brax_torch.envs.assets.swimmer import swimmer_config
    from brax_torch.sim import builder

    cfg = swimmer_config()
    cfg.forces[0].kind = "twister"
    return builder.build(cfg, device=device)[0]


# legacy spring: the eight envs whose legacy_spring=True switches to a
# spring scene, each held from a reset and after 10 twin steps on actions
# uniform in [-1, 1] (reacherangle's in degrees, +-300, past its joints'
# limits); inverted_double_pendulum's env cannot reset in legacy spring (nor
# can the JAX one: its hinges' (0, 0) limits give no default angles for the
# joint noise), so its first state is default_qp, both angles 0
SPRING_SCENES = ("ant", "halfcheetah", "humanoid_legacy", "humanoidstandup",
                 "inverted_pendulum", "inverted_double_pendulum", "reacher", "reacherangle")
SPRING_STATES = ("reset", "after 10 twin steps")


def spring_env(name, n, device):
    """The bare env `name` made with legacy_spring=True, n envs."""
    from brax_torch import envs

    return envs.create(name, episode_length=None, auto_reset=False, batch_size=n,
                       device=device, legacy_spring=True).unwrapped


def spring_actions(name, env, n, gen, device):
    """(n, action_size) actions uniform in [-1, 1]; reacherangle's x 300."""
    act = torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    return act * 300.0 if name == "reacherangle" else act


def spring_states(name, env, n, seed, device, sys_=None):
    """{state: (qp, act)} of a spring scene at n envs (SPRING_STATES), each
    with one more action; the twin steps `sys_` (default env.sys)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = lambda: spring_actions(name, env, n, gen, device)
    if name == "inverted_double_pendulum":
        zero = torch.zeros((n, 0), device=device)
        reset = env.default_qp(joint_angle=zero, joint_velocity=zero)
    else:
        reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(sys_ or env.sys, settled, act())
    return {SPRING_STATES[0]: (reset, act()), SPRING_STATES[1]: (settled, act())}


# every composer scene of the registry, by its task name: (task, desc
# kwargs); "chase4" is the 4-agent chase of brax_torch/tools/bench_composer.py
COMPOSER_SCENES = {"ant_run": ("ant_run", {}), "pro_ant_run": ("pro_ant_run", {}),
                   "ant_push": ("ant_push", {}), "ant_on_ball": ("ant_on_ball", {}),
                   "halfcheetah_run": ("halfcheetah_run", {}),
                   "humanoid_run": ("humanoid_run", {}), "ant_chase": ("ant_chase", {}),
                   "chase": ("chase", {}), "follow": ("follow", {}), "sumo": ("sumo", {}),
                   "chase4": ("chase", {"num_agents": 4}),
                   "octopus_run": ("octopus_run", {})}
# the wide scenes (PBD_WIDE) held against the twin: the 2-agent chase and
# the 4-agent chase, each from a reset (the ants on a circle of radius 2,
# on the ground), 10 twin steps after it on uniform actions, and with the
# ants drawn together (ants_overlapping), on one more action
COMPOSER_WIDE = ("chase", "chase4")
COMPOSER_STATES = ("reset", "after 10 twin steps", "ants overlapping")
# each agent's root drawn toward the agents' centroid to this share of its
# distance (uniform per env and agent): 0.8-1.6 between the two chase ants,
# 0.57-1.13 between neighbours of the four, so that legs of different ants
# overlap
OVERLAP_SHARE = (0.2, 0.4)


def composer_scene(scene, n, device, **kwargs):
    """The composer scene's env at n envs (`composer.envs.create_env` with
    `kwargs`: its wrappers)."""
    from brax_torch.composer import envs as composer_envs

    task, desc = COMPOSER_SCENES[scene]
    return composer_envs.create_env(task, batch_size=n, device=device, **desc, **kwargs)


def composer_env(scene, n, device):
    """The bare env of a composer scene, n envs."""
    return composer_scene(scene, n, device, episode_length=None, auto_reset=False).unwrapped


def ants_overlapping(env, qp, gen):
    """qp with each agent (every body of it) moved in x and y so that its
    root lies at the agents' centroid plus a share OVERLAP_SHARE of its
    offset from it, drawn per env and agent."""
    agents = [env.component_meta[a] for a in env.agent_names]
    n, device = qp.pos.shape[0], qp.pos.device
    roots = torch.stack([qp.pos[:, m["root_idx"], :2] for m in agents], dim=1)
    centre = roots.mean(dim=1, keepdim=True)
    lo, hi = OVERLAP_SHARE
    share = lo + (hi - lo) * torch.rand((n, len(agents), 1), generator=gen, device=device)
    shift = (centre + share * (roots - centre)) - roots
    pos = qp.pos.clone()
    for k, m in enumerate(agents):
        pos[:, m["body_idx"], :2] += shift[:, k, None, :]
    return type(qp)(pos=pos, rot=qp.rot, vel=qp.vel, ang=qp.ang)


def composer_states(name, env, n, seed, device):
    """{state: (qp, act)} of a COMPOSER_WIDE scene (`env` unwrapped, n envs)
    at COMPOSER_STATES, each with one more action uniform in [-1, 1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = lambda: torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(env.sys, settled, act())
    return {COMPOSER_STATES[0]: (reset, act()), COMPOSER_STATES[1]: (settled, act()),
            COMPOSER_STATES[2]: (ants_overlapping(env, reset, gen), act())}


# octopus_run: legacy spring on the wide route (28 bodies, 26 spring
# hinges, 50 one-way capsule-plane contact points: 64 lanes), held from a
# reset, 10 twin steps after it on uniform actions, and the reset with its
# velocities and angular velocities moved by JIGGLE x a standard normal
# draw under the frozen-axis masks (as tests/test_pallas_kernel.py jiggles
# its spring scene), each on one more action uniform in [-1, 1]
OCTOPUS = "octopus_run"
OCTOPUS_STATES = ("reset", "after 10 twin steps", "jiggled")
JIGGLE = 0.3


def octopus_states(env, n, seed, device):
    """{state: (qp, act)} of octopus_run (`env` unwrapped, n envs) at
    OCTOPUS_STATES."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = lambda: torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(env.sys, settled, act())
    integ = env.sys.integrator
    kick = lambda x, mask: x + JIGGLE * torch.randn(x.shape, generator=gen, device=device) * mask
    jiggled = type(reset)(pos=reset.pos, rot=reset.rot, vel=kick(reset.vel, integ.pos_mask),
                          ang=kick(reset.ang, integ.rot_mask))
    return {OCTOPUS_STATES[0]: (reset, act()), OCTOPUS_STATES[1]: (settled, act()),
            OCTOPUS_STATES[2]: (jiggled, act())}


# biggym (brax_torch/biggym): the Systems of its 12 registry and match
# scenes that no earlier scene has (race_ant_ant's is v1 ant's,
# jump_cheetah's halfcheetah's, sumo_ant_ant's the composer chase's), one
# scene each: onigokko's predator matches are its prey matches mirrored,
# and the race match shares the ant-against-proant prey match's System.
# Each is held from a reset (which draws nothing: every env alike) and 10
# twin steps after it on uniform actions, each on one more action
BIGGYM_SCENES = ("race_proant_ant", "chase_proant_ant", "sumo_proant_ant",
                 "match_race_ma__ant_ant__proant_ant", "match_sumo__ant_ant__proant_ant",
                 "match_onigokko_prey__proant_ant__ant_ant")
BIGGYM_STATES = ("reset", "after 10 twin steps")


def biggym_registry():
    """brax_torch.biggym with its registry filled (register_all, then
    register_matches, once)."""
    from brax_torch import biggym

    biggym.register_all()
    if not biggym.ENVS_BY_TRACKS["goal_oriented_matches"]:
        biggym.register_matches()
    return biggym


def biggym_env(scene, n, device):
    """The bare env of a biggym scene, n envs (a plain env, jump_cheetah, is
    built bare; a task env without its wrappers)."""
    biggym = biggym_registry()
    if scene in biggym.ENVS_BY_TRACKS["open_ended"]:
        return biggym.create(scene, batch_size=n, device=device)
    return biggym.create(scene, batch_size=n, device=device, episode_length=None,
                         auto_reset=False).unwrapped


def biggym_states(env, n, seed, device):
    """{state: (qp, act)} of a biggym scene (`env` bare, n envs) at
    BIGGYM_STATES, each with one more action uniform in [-1, 1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    act = lambda: torch.rand((n, env.action_size), generator=gen, device=device) * 2 - 1
    reset = env.reset(gen).qp
    settled = reset
    for _ in range(10):
        settled, _ = kernels.pbd_step_plain(env.sys, settled, act())
    return {BIGGYM_STATES[0]: (reset, act()), BIGGYM_STATES[1]: (settled, act())}

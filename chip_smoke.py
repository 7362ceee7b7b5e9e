"""Smoke test of the brax_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds brax_torch/csrc/pbd_step.cu with nvcc (sm_90a) for the v1 ant's,
   humanoid's, humanoidstandup's, halfcheetah's, pusher's,
   inverted_pendulum's, inverted_double_pendulum's, swimmer's,
   reacherangle's, reacher's, grasp's, acrobot's, ur5e's, fetch's,
   hopper's and walker2d's Systems, the eight legacy-spring Systems (and
   grasp's, fetch's and the spring ones' one-pass Systems and swimmer's
   with a twister; each scene's header in front,
   brax_torch.sim.kernels.kernel_source) and prints ptxas's register and
   spill reports and the launches (lanes per env, envs per block, resident
   blocks per SM, waves);
3. holds the kernel against its plain-torch twin at the main path's shapes:
   ant at 4096 envs, from a contact-rich state (10 twin steps after reset).
   Every output (pos, rot, vel, ang and the contact vel/ang impulses) is
   held to the tolerance.  At most MAX_OUTLIERS envs may fall outside it,
   and each only if the twin, fed its input with noise of a few float32
   ulps, reproduces the kernel's output there;
4. drives the main path: envs.create("ant", batch_size=4096), reset, 200
   env.step calls with random actions, and checks that the kernel ran once
   per step and that every observation is finite;
5. times the kernel at 128, 2048 and 4096 envs (PPO's eval, PPO's
   training batch, the env.step path), replayed from a CUDA graph and
   issued by the host, beside its bound; the twin and env.step;
6. holds the fused MLP kernels (brax_torch/csrc/fused_mlp.cu, forward and
   backward) against their plain versions at the PPO ant recipe's shapes,
   with v1 ant's 87-wide and v2 ant's 27-wide observation, in bf16 and f32
   modes, and prints each shape's launch (fused_mlp.card_plan: pipeline
   stages, row tile, grid, shared memory);
7. drives PPO: ppo.train on ant with the published recipe
   (DEFAULT_PPO_PARAMS["ant"]) at full width for 3 training steps and one
   evaluation of 128 envs, and checks the exact launch counts of all three
   kernels, finite losses, changed parameters and a finite eval reward;
8. times the fused kernels and the same chains as F.linear calls (cuBLAS,
   a yardstick) replayed from CUDA graphs and issued by the host, their
   plain versions, PPO env-steps/s with the fused kernels on and off, and
   profiles one training step each way;
9. the v1 humanoid (the PBD kernel built for its scene of spherical
   joints, PBD_SPHERICAL, and for humanoidstandup's, 32 lanes for its 22
   contacts): each held against the twin at 4096 envs from a reset and
   after 10 twin steps, with the rule of step 3; the main paths
   envs.create(name, batch_size=4096) of humanoid (200 steps, profiled),
   humanoid_legacy and humanoidstandup (50 each), one launch per step; the
   kernel timed as in step 5 beside its bound; the fused MLP kernels held
   and timed at the humanoid recipe's shapes (240-wide observation, a
   34-wide policy head, 10,240-row minibatches); PPO at
   DEFAULT_PPO_PARAMS["humanoid"] for 2 training steps and one evaluation
   of 128 envs, with exact launch counts (per training step 160 PBD, 928
   fused forward, 512 backward) and its env-steps/s;
9b. v1 halfcheetah and pusher (the PBD kernel's two-way capsule-capsule
   group, PBD_CAPCAP; "v1 halfcheetah" apart from step 13's generalized
   one): each held against the twin at 4096 envs from a reset, after 10
   twin steps and with its capsule-capsule pairs overlapping (capcap_state),
   over one pass (the System with 2 substeps, built beside the scene's) and
   over the whole step, each by the rule pbd_parity.RULES names for the
   scene and state: the rule of step 3, or, for a chaotic step
   (halfcheetah's, but over one pass from a reset; pusher's whole step
   after 10 steps and with its pairs overlapping), chaos_rule (each env
   within CHAOS_RATIO x the twin's own spread, in all but CHAOS_SHARE of
   the envs); the main
   paths envs.create(name, batch_size=4096) of halfcheetah (200 steps,
   profiled) and pusher (50), one launch per step; the kernel timed as in
   step 5 beside its bound; the fused MLP kernels held and timed at the
   halfcheetah recipe's shapes (18-wide observation, a 12-wide policy head,
   10,240-row minibatches); PPO at DEFAULT_PPO_PARAMS["halfcheetah"] for 2
   training steps and one evaluation of 128 envs, with exact launch counts
   (per training step 160 PBD, 928 fused forward, 512 backward);
9c. the v1 scenes without contacts: the PBD kernel's thruster group
   (PBD_FORCES: inverted_pendulum and inverted_double_pendulum, no
   actuators, and swimmer), its angle actuators (PBD_ANGLE: reacherangle)
   and reacher, each held against the twin at 4096 envs from a reset and
   after 10 twin steps with the rule of step 3, on its physics actions
   (inverted_pendulum's real 1-wide action, swimmer's 11 columns,
   reacherangle's targets past its joints' limits); the main paths
   envs.create(name, batch_size=4096) of swimmer (200 steps, profiled) and
   the other four (50 each), one launch per step; the kernel timed as in
   step 5 beside its bound; PPO at DEFAULT_PPO_PARAMS["reacher"]
   (action_repeat 4) for 2 training steps and one evaluation of 128 envs,
   with exact launch counts (per training step 800 PBD, 968 fused forward,
   512 backward) and its env-steps/s (scripts/profile_ppo_step.py profiles
   its training step apart: the trace's processing takes minutes);
9d. v1 grasp (the PBD kernel's one-way capsule-capsule lanes,
   PBD_CAPCAP_ONEWAY, and angle actuators on spherical joints,
   PBD_SPHERICAL_ANGLE) held against the twin at 4096 envs from a reset
   and with its claw closed on the ball (pbd_parity.grasp_states), over one
   pass and over the whole step, each by the rule pbd_parity.RULES names
   (the rule of step 3); swimmer with its torso's thruster made a twister,
   and v1 acrobot and ur5e, after 10 twin steps by the rule of step 3; the
   main paths envs.create(name, batch_size=4096) of grasp (200 steps,
   profiled), acrobot and ur5e (50 each), one launch per step; the kernel
   timed per scene as in step 5 beside its bound; the fused MLP kernels
   held and timed at the grasp recipe's shapes (132-wide observation, a
   78-wide policy head, 5120-row minibatches); PPO at
   DEFAULT_PPO_PARAMS["grasp"] for 2 training steps and one evaluation of
   128 envs, with exact launch counts (per training step 80 PBD, 272 fused
   forward, 128 backward) and its env-steps/s;
9e. v1 fetch (the PBD kernel's one-way box-plane contacts: each box
   corner a capsule-plane lane of radius 0, 32 lanes, eight corners to a
   lower leg) held against the twin at 4096 envs from a reset and with its
   feet on the ground (pbd_parity.fetch_states), and v1 hopper and
   walker2d from a reset and after 10 twin steps, over one pass and over
   the whole step, each by the rule pbd_parity.RULES names (the rule of
   step 3); the main paths envs.create(name, batch_size=4096) of fetch
   (200 steps, profiled), hopper and walker2d (50 each), one launch per
   step; the kernel timed per scene as in step 5 beside its bound; the
   fused MLP kernels held and timed at the fetch recipe's shapes (101-wide
   observation, a 20-wide policy head, 5120-row minibatches); PPO at
   DEFAULT_PPO_PARAMS["fetch"] for 2 training steps and one evaluation of
   128 envs, with exact launch counts (per training step 80 PBD, 464 fused
   forward, 256 backward) and its env-steps/s;
9f. legacy spring (the PBD kernel's PBD_SPRING section: the step's
   substeps of spring joints, actuators and forces, then velocity-level
   contacts), on the eight envs legacy_spring=True switches: each spring
   System held against the twin at 4096 envs from a reset (the double
   pendulum's, which cannot reset, default_qp) and after 10 twin steps
   (pbd_parity.spring_states), over one substep (the System with 1
   substep, a kernel of its own) and over the whole step, each by the rule
   pbd_parity.RULES names ("<env>_spring"); the main paths
   envs.create(name, batch_size=4096, legacy_spring=True) of ant (200
   steps, profiled) and six more (50 each), one launch per step, and the
   double pendulum's System stepped 50 times from default_qp (its env's
   reset raises, as the JAX env's does); the kernel timed per scene as in
   step 5 beside its bound; PPO at DEFAULT_PPO_PARAMS["ant"] on a factory
   of envs.create_fn("ant", legacy_spring=True) for 2 training steps and
   one evaluation of 128 envs, with exact launch counts (per training step
   80 PBD, 464 fused forward, 256 backward: ant's shapes, whose fused
   kernels step 6 holds);
10. holds the generalized-step kernel (brax_torch/csrc/gen_step.cu, built
   for the v2 ant) against its plain version at 4096 envs from a state 10
   plain env steps after reset, at one frame and at ant's five, with the
   rounding rule of step 3 (at most GEN_MAX_OUTLIERS envs), and at five
   frames from a contact-rich reset (the torso lowered);
11. drives the v2 main path: brax_torch.v2.envs.create("ant",
   batch_size=4096), reset, 200 env.step calls, one kernel launch each;
12. times that kernel, its plain version and v2 env.step, profiles 20
   env.step calls, counts the plain version's operations for the bound,
   and times the kernel (a warp per env) at every envs-per-block its
   shared memory allows, at 4096 and 16384 envs (one pass);
13. holds the generalized-step kernel of each other v2 env (inverted
   pendulum, inverted double pendulum, reacher, halfcheetah, hopper,
   walker2d) against its plain version at 4096 envs and the env's n_frames,
   from a reset and, for the three with floor contacts, from a reset with
   the torso lowered into contact, with the rule of step 10;
14. drives each of those envs' main path: brax_torch.v2.envs.create(name,
   batch_size=4096), reset, 50 env.step calls, one launch each, and times
   the step, the kernel and its plain version beside the kernel's bound;
15. drives PPO on the v2 ant: ppo.train with a factory of the bare v2 ant at
   the ant recipe for 3 training steps and one evaluation of 128 envs, with
   exact launch counts of gen_step and of the fused MLP kernels, then
   times PPO env-steps/s with the fused kernels on and off in turns and
   profiles one training step each way;
16. reads the launch-overhead probe's counts, set to 0 before step 3, to
   show that no env or PPO path ran its kernels; holds them
   (brax_torch/csrc/probe.cu) against their plain versions, counts the
   HGMMA (wgmma) instructions in the dot chain's build (cuobjdump), then
   drives the probe (brax_torch.tools.probe_overhead.measure), which times
   every launch both issued by the host and replayed from a CUDA graph;
17. prints one JSON line listing every kernel and, last,
   {"ok": true, "device": {...}}.

The CUDA sources are built at the start, one nvcc each, in parallel (the
generalized step once per v2 scene); for each scene the generalized step's
launch is printed: ptxas's registers, stack and spills, shared memory per
env and per block, envs per block, resident blocks per SM and waves at
4096 envs and at PPO's batch.  Each gen_step parity check also counts the
envs whose outputs are bit-identical to the plain version's.
It fails, printing no result, without a CUDA device.  Imports nothing of
JAX.
"""

import json
import re
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from brax_torch import cuda_build, envs
from brax_torch.braxlines.defaults import DEFAULT_PPO_PARAMS
from brax_torch.sim import kernels
from brax_torch.tools import probe_overhead as probe
from brax_torch.tools.pbd_parity import (MAX_OUTLIERS, PERTURBED_COPIES, ROUNDING_NOISE,
                                         RULES, SPRING_SCENES, STATES, TOLERANCE, capcap_share,
                                         capcap_state, contact_share, corners_down, fetch_states,
                                         fingertips_on_ball, force_scene_states, grasp_states,
                                         hold_capcap, max_errors, one_pass, spring_env,
                                         spring_states, twister_swimmer)
from brax_torch.training import fused_mlp
from brax_torch.training.agents.ppo import networks as ppo_networks
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

N_ENVS = 4096
MAIN_STEPS = 200
# H100 SXM data sheet: HBM3 bandwidth, fp32 rate outside the tensor cores,
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the PPO ant recipe's MLP chains (make_ppo_networks' defaults, 8 actions):
# v1 ant's 87-wide observation, and v2 ant's 27-wide one ("_v2")
CHAINS = {"value": [87] + [256] * 5 + [1], "policy": [87] + [32] * 4 + [16],
          "value_v2": [27] + [256] * 5 + [1], "policy_v2": [27] + [32] * 4 + [16],
          "value_humanoid": [240] + [256] * 5 + [1],
          "policy_humanoid": [240] + [32] * 4 + [34],
          "value_halfcheetah": [18] + [256] * 5 + [1],
          "policy_halfcheetah": [18] + [32] * 4 + [12],
          "value_grasp": [132] + [256] * 5 + [1],
          "policy_grasp": [132] + [32] * 4 + [78],
          "value_fetch": [101] + [256] * 5 + [1],
          "policy_fetch": [101] + [32] * 4 + [20]}
# (chain, rows) as the PPO paths launch them: minibatch [T=5, 1024] losses
# (5120 rows), the rollout's policy at 2048 envs, the bootstrap value at 1024
CHAIN_SHAPES = [(c + v, r) for v in ("", "_v2")
                for c, r in (("value", 5120), ("policy", 5120), ("policy", 2048), ("value", 1024))]
# the humanoid recipe's: minibatch [T=10, 1024] losses (10,240 rows), the
# rollout's policy at 2048 envs, the eval's at 128, the bootstrap value at
# 1024; parity at each, both chains; timed at the shapes a training step
# launches
HUMANOID_PARITY_SHAPES = [(c + "_humanoid", r) for c in ("value", "policy")
                          for r in (10240, 2048, 128)] + [("value_humanoid", 1024)]
HUMANOID_TIMING_SHAPES = [("value_humanoid", 10240), ("policy_humanoid", 10240),
                          ("policy_humanoid", 2048), ("value_humanoid", 1024)]
# the halfcheetah recipe's (batch 512 x unroll 20): minibatch losses at
# 10,240 rows, the rollout's policy at 2048 envs, the eval's at 128, the
# bootstrap value at 512; parity also at 1024; timed at a training step's
HALFCHEETAH_PARITY_SHAPES = [(c + "_halfcheetah", r) for c in ("value", "policy")
                             for r in (10240, 2048, 1024, 128)] + [("value_halfcheetah", 512)]
HALFCHEETAH_TIMING_SHAPES = [("value_halfcheetah", 10240), ("policy_halfcheetah", 10240),
                             ("policy_halfcheetah", 2048), ("value_halfcheetah", 512)]
# the grasp recipe's (batch 256 x unroll 20): minibatch losses at 5120 rows,
# the rollout's policy at 2048 envs, the eval's at 128, the bootstrap value at
# 256; timed at a training step's
GRASP_PARITY_SHAPES = [(c + "_grasp", r) for c in ("value", "policy")
                       for r in (5120, 2048, 128)] + [("value_grasp", 256)]
GRASP_TIMING_SHAPES = [("value_grasp", 5120), ("policy_grasp", 5120), ("policy_grasp", 2048),
                       ("value_grasp", 256)]
# the fetch recipe's (batch 256 x unroll 20, as grasp's): minibatch losses at
# 5120 rows, the rollout's policy at 2048 envs, the eval's at 128, the
# bootstrap value at 256; timed at a training step's
FETCH_PARITY_SHAPES = [(c + "_fetch", r) for c in ("value", "policy")
                       for r in (5120, 2048, 128)] + [("value_fetch", 256)]
FETCH_TIMING_SHAPES = [("value_fetch", 5120), ("policy_fetch", 5120), ("policy_fetch", 2048),
                       ("value_fetch", 256)]
# f32 mode: tests/test_fused_mlp.py's tolerances (|err| <= atol + rtol |plain|)
F32_TOL = {"fwd": (2e-5, 2e-5), "bwd": (2e-4, 2e-5)}
# bf16 mode: max |kernel - plain| <= BF16_REL * max |plain|, per output.  The
# two round the same values to bf16, but f32 sums taken in another order
# can round an activation to a neighbouring bf16 number
BF16_REL = 1e-2
# wrapper calls captured in one CUDA graph when a chain is timed replayed
GRAPH_CALLS = 20
# generalized step: tests/test_v2_generalized_kernel.py's tolerances, and its
# per-env bounds for several chained frames (median and p90 of the largest
# error per env, q and qd), printed beside them for the five-frame step
GEN_TOLERANCE = {"q": 2e-5, "qd": 2e-4, "minv": 2e-5, "x_pos": 2e-5, "x_rot": 2e-5,
                 "xd_ang": 2e-4, "xd_vel": 2e-4, "c_pos": 2e-5, "c_pen": 2e-5}
GEN_MULTI_FRAME_BOUNDS = {"q": (5e-5, 1e-3), "qd": (5e-4, 1e-2)}
GEN_MAX_OUTLIERS = 8
GEN_FRAMES = 5  # ant's n_frames (brax_tpu/v2/envs/ant.py:32)
# the reference's static count of one gen ant env step (bench.py:291)
GEN_REFERENCE_FLOPS = 687_989
# batch sizes of the gen_step envs-per-block sweep (one pass each)
GEN_SWEEP_ENVS = (N_ENVS, 4 * N_ENVS)
# the v2 envs beside ant, and those of them with floor contacts
V2_ENVS = ("inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah", "hopper",
           "walker2d")
V2_CONTACT_ENVS = ("halfcheetah", "hopper", "walker2d")
V2_ENV_STEPS = 50
# the contact-rich start: the torso lowered until its lowest contact point
# touches the floor, and by up to this much further
V2_LOWER = 0.1
PPO_STEPS = 3
PPO_EVAL_ENVS = 128
# v1 humanoid: the spherical scenes held to the twin, each env's main-path
# steps and observation width, and PPO's training steps at its recipe
HUMANOID_SCENES = ("humanoid", "humanoidstandup")
HUMANOID_ENV_STEPS = {"humanoid": MAIN_STEPS, "humanoid_legacy": 50, "humanoidstandup": 50}
HUMANOID_OBS = 240
# the main paths each spherical scene's kernel runs (humanoid_legacy's
# System is humanoid's)
HUMANOID_MAIN_PATHS = {"humanoid": ("humanoid", "humanoid_legacy"),
                       "humanoidstandup": ("humanoidstandup",)}
PPO_HUMANOID_STEPS = 2
# v1 halfcheetah and pusher: the two-way capsule-capsule group
# (PBD_CAPCAP).  Labelled "v1 ..." apart from V2_ENVS' generalized halfcheetah
CAPCAP_SCENES = ("halfcheetah", "pusher")
CAPCAP_LABEL = {"halfcheetah": "v1 halfcheetah", "pusher": "v1 pusher"}
CAPCAP_ENV_STEPS = {"halfcheetah": MAIN_STEPS, "pusher": 50}
CAPCAP_OBS = {"halfcheetah": 18, "pusher": 23}
PPO_HALFCHEETAH_STEPS = 2
# the v1 scenes without contacts: thrusters (the inverted pendulums and
# swimmer, PBD_FORCES), angle actuators (reacherangle, PBD_ANGLE) and reacher
FORCE_SCENES = ("inverted_pendulum", "inverted_double_pendulum", "swimmer", "reacherangle",
                "reacher")
FORCE_ENV_STEPS = {"inverted_pendulum": 50, "inverted_double_pendulum": 50, "swimmer": MAIN_STEPS,
                   "reacherangle": 50, "reacher": 50}
FORCE_OBS = {"inverted_pendulum": 4, "inverted_double_pendulum": 8, "swimmer": 8,
             "reacherangle": 11, "reacher": 11}
PPO_REACHER_STEPS = 2
# v1 grasp (one-way capsule-capsule contacts, PBD_CAPCAP_ONEWAY; angle
# actuators on spherical joints, PBD_SPHERICAL_ANGLE), and acrobot and ur5e
# (revolute joints, torque actuators, no contacts): each env's main-path
# steps and observation width
GRASP_ENV_STEPS = {"grasp": MAIN_STEPS, "acrobot": 50, "ur5e": 50}
GRASP_OBS = {"grasp": 132, "acrobot": 4, "ur5e": 66}
PPO_GRASP_STEPS = 2
# v1 fetch (one-way box-plane contacts on the capsule-plane lanes, radius
# 0), hopper and walker2d (one-way capsule-plane contacts): each env's
# main-path steps and observation width
FETCH_ENV_STEPS = {"fetch": MAIN_STEPS, "hopper": 50, "walker2d": 50}
FETCH_OBS = {"fetch": 101, "hopper": 11, "walker2d": 17}
PPO_FETCH_STEPS = 2
# legacy spring: the eight envs legacy_spring=True switches (PBD_SPRING),
# each env's main-path steps and observation width (the humanoids' 227: the
# spring System's 17 unpadded dofs); inverted_double_pendulum's env cannot
# reset in legacy spring, so its System steps from default_qp
SPRING_ENV_STEPS = {name: MAIN_STEPS if name == "ant" else 50 for name in SPRING_SCENES}
SPRING_OBS = {"ant": 87, "halfcheetah": 18, "humanoid_legacy": 227, "humanoidstandup": 227,
              "inverted_pendulum": 4, "reacher": 11, "reacherangle": 11}
PPO_SPRING_STEPS = 2
# the factory PPO trains the spring ant on
SPRING_ANT = envs.create_fn("ant", legacy_spring=True, episode_length=None, auto_reset=False)
# the PBD kernel's batch sizes: PPO's eval, PPO's training batch, env.step's
PBD_TIMING_ENVS = (PPO_EVAL_ENVS, 2048, N_ENVS)
PROFILE_EPISODE = 10
DEVICE = torch.device("cuda")


def cuda_ms(fn, reps, warmup):
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class OpCount(TorchDispatchMode):
    """Counts elementwise arithmetic, compare and reduce operations."""

    ELEMENTWISE = {
        "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "exp", "sin", "cos",
        "abs", "sign", "minimum", "maximum", "clamp", "clamp_min", "clamp_max", "where",
        "lt", "gt", "le", "ge", "eq", "ne", "logical_and", "logical_or", "bitwise_and",
        "bitwise_or", "acos", "reciprocal", "pow", "square",
    }
    REDUCE = {"sum", "any", "all", "amax", "linalg_vector_norm"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.ELEMENTWISE:
            self.ops += out.numel()
        elif name in self.REDUCE:
            self.ops += args[0].numel()
        elif name == "index_add":
            self.ops += args[3].numel()
        return out


def pbd_bound(sys_, qp, act):
    """(bound_ms, bound_by, ops, bytes, bytes_ms, ops_ms) of one PBD launch on
    these inputs: the twin's operations (OpCount: the thrusters' and
    twisters' multiplies, divisions and index_add, the angle actuators'
    clamp and PD arithmetic among them) at the fp32 rate against the bytes
    moved (13 floats in and 19 out per body, the actions, the scene's
    tables) at the HBM rate."""
    counter = OpCount()
    with counter:
        kernels.pbd_step_plain(sys_, qp, act)
    n, n_act, nb = act.shape[0], act.shape[1], sys_.num_bodies
    ftab, itab = kernels.pack_tables(sys_)
    n_bytes = 4 * n * (13 * nb + n_act + 19 * nb) + ftab.nbytes + itab.nbytes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = counter.ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", counter.ops,
            n_bytes, bytes_ms, ops_ms)


def profile_env_step(tag, label, env, state, act_gen, steps=20):
    """Device time and kernels per env.step over `steps` calls (the
    profiler); prints the top kernels.  Returns (state, record)."""
    from torch.profiler import ProfilerActivity, profile

    n = state.obs.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            act = torch.rand((n, env.action_size), generator=act_gen, device=DEVICE) * 2 - 1
            state = env.step(state, act)
        torch.cuda.synchronize()
    device_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rec = {"device_us_per_step": sum(device_us(e) for e in events) / steps,
           "kernels_per_step": sum(e.count for e in events) / steps}
    if rec["device_us_per_step"]:
        print(f"profile {tag}: {steps} {label} env.step calls, {rec['device_us_per_step']:.1f} "
              f"us device time and {rec['kernels_per_step']:.0f} kernels per step")
        for e in sorted(events, key=lambda e: -device_us(e))[:6]:
            print(f"  {device_us(e) / steps:9.1f} us/step  {e.count / steps:6.2f}/step  "
                  f"{e.key[:90]}")
    else:
        print(f"profile: {label} env.step: no device time recorded (not measured)")
    return state, rec


def v1_main_path(tag, name, steps, obs_width, warm, label=None, **kwargs):
    """`steps` env.step calls of envs.create(name, batch_size=N_ENVS,
    **kwargs) with random actions, exactly one PBD launch each (counts set
    to 0 just before, read just after), finite observations of
    `obs_width`; printed as `label` (default: name).  Returns (env, state,
    act_gen, record)."""
    label = label or name
    env = envs.create(name, episode_length=1000, auto_reset=True, batch_size=N_ENVS, **kwargs)
    state = env.reset(torch.Generator(device=DEVICE).manual_seed(1))
    act_gen = torch.Generator(device=DEVICE).manual_seed(2)
    kernels.pbd_step_launch.launches = 0
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        act = torch.rand((N_ENVS, env.action_size), generator=act_gen, device=DEVICE) * 2 - 1
        state = env.step(state, act)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (steps - warm)
    launches = kernels.pbd_step_launch.launches
    if launches != steps:
        raise AssertionError(f"{steps} {label} env steps made {launches} kernel launches")
    if not bool(torch.isfinite(state.obs).all()):
        raise AssertionError(f"non-finite {label} observations after the main path")
    if state.obs.shape != (N_ENVS, obs_width):
        raise AssertionError(f"{label} obs shape {tuple(state.obs.shape)}")
    done = float(state.done.mean())
    print(f"main path {label}: {steps} env.step calls, {launches} kernel launches, obs "
          f"{tuple(state.obs.shape)} finite, done fraction {done:.4f}; env.step "
          f"{step_s * 1e3:.4f} ms/step, {N_ENVS / step_s:.1f} env-steps/s (host clock, "
          f"{steps - warm} steps) {tag}")
    return env, state, act_gen, {"launches": launches, "done_fraction": done,
                                 "env_step_ms": step_s * 1e3, "env_steps_per_s": N_ENVS / step_s}


def pbd_launch_report(sys_, batches, label="ant"):
    """The PBD kernel's launch for a System: ptxas's figures, lanes per env,
    envs and threads per block, resident blocks per SM (the CUDA runtime's
    occupancy) and, per batch size, blocks, SMs used and waves."""
    p = kernels.plan(sys_)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = kernels.resident_blocks(sys_)
    rec = {**ptxas_figures(kernels.ptxas_report(sys_)), "lanes": p.lanes,
           "envs_per_block": p.envs_per_block, "threads_per_block": p.threads,
           "resident_blocks_per_sm": resident}
    for n in batches:
        blocks, _ = kernels.launch_geometry(p, n)
        rec[f"at_{n}"] = {"blocks": blocks, "sms_used": min(blocks, sms),
                          "waves": blocks / (sms * resident)}
    print(f"pbd_step launch {label}: {rec['registers']} registers, stack {rec['stack_bytes']} B, "
          f"spills "
          f"{rec['spill_store_bytes']}/{rec['spill_load_bytes']} B; {p.lanes} lanes per env, "
          f"{p.envs_per_block} envs ({p.threads} threads) per block, {resident} blocks resident "
          f"per SM; " + "; ".join(f"{n} envs: {r['blocks']} blocks on {r['sms_used']} SMs, "
                                  f"{r['waves']:.2f} waves"
                                  for n, r in ((n, rec[f"at_{n}"]) for n in batches)))
    return rec


def pbd_timings(tag, sys_, qp, act, bound_per_env, label="ant"):
    """The PBD kernel at each of PBD_TIMING_ENVS envs (the first n envs of
    the contact-rich state): ms per launch replayed from a CUDA graph of
    GRAPH_CALLS launches and issued by the host, and its bound."""
    rec = {}
    for n in PBD_TIMING_ENVS:
        ins = tuple(t[:n].contiguous() for t in (qp.pos, qp.rot, qp.vel, qp.ang, act))
        new = lambda i: kernels.pbd_step_launch(sys_, *ins)
        r = {"graph": probe.graph_us(new, GRAPH_CALLS) / 1e3,
             "host": probe.host_us(new, GRAPH_CALLS) / 1e3,
             "bound_ms": n * bound_per_env}
        rec[n] = r
        print(f"timing {tag}: pbd_step {label} at {n} envs: {r['graph']:.5f} ms graph-replayed, "
              f"{r['host']:.5f} ms host-issued; bound {r['bound_ms']:.5f} ms")
    return rec


# ---------------------------------------------------------------------------
# generalized step (v2)
# ---------------------------------------------------------------------------


def gen_per_env_errors(a, b):
    """{output: (N,) max abs error per env}, over the outputs the scene has
    (no contact outputs without contacts)."""
    n = a["q"].shape[0]
    return {k: (a[k] - b[k]).abs().reshape(n, -1).amax(dim=1) for k in GEN_TOLERANCE if k in a}


def gen_rounding_decided(sys_, ins, n_frames, idx, kernel_out, gen):
    """rounding_decided for the generalized step: each outlier env's
    (q, qd, M^-1, act) copied PERTURBED_COPIES times with relative noise of
    ROUNDING_NOISE, stepped by the plain version, and held to GEN_TOLERANCE
    against the kernel's output."""
    k = PERTURBED_COPIES
    scale = torch.tensor(ROUNDING_NOISE, device=DEVICE).repeat(k // len(ROUNDING_NOISE))

    def noisy(x):
        rep = x[idx].repeat_interleave(k, dim=0)
        u = torch.rand(rep.shape, generator=gen, device=DEVICE) * 2 - 1
        s = scale.repeat(len(idx)).reshape((-1,) + (1,) * (rep.dim() - 1))
        return rep * (1 + s * u)

    q, qd, minv, act = ins
    out = gen_kernels.gen_step_plain(sys_, noisy(q), noisy(qd), noisy(minv),
                                     act[idx].repeat_interleave(k, dim=0), n_frames)
    want = {f: v[idx].repeat_interleave(k, dim=0) for f, v in kernel_out.items()}
    errs = gen_per_env_errors(out, want)
    ok = torch.stack([e <= GEN_TOLERANCE[f] for f, e in errs.items()]).all(dim=0)
    return ok.reshape(len(idx), k).any(dim=1)


def gen_max_errors(sys_, ins, n_frames, gen, label):
    """Kernel vs plain version at n_frames: as max_errors, on GEN_TOLERANCE,
    with at most GEN_MAX_OUTLIERS envs, each decided by rounding.  Also
    prints the per-env median and p90 of the q and qd errors beside
    GEN_MULTI_FRAME_BOUNDS and raises if they exceed them, and counts the
    envs whose outputs all equal the plain version's bit for bit.  Returns
    (errors, errors within tolerance, outliers, bit-identical envs)."""
    out = gen_kernels.gen_step(sys_, *ins, n_frames)
    ref = gen_kernels.gen_step_plain(sys_, *ins, n_frames)
    torch.cuda.synchronize()
    per_env = gen_per_env_errors(out, ref)
    over = torch.stack([~(e <= GEN_TOLERANCE[k]) for k, e in per_env.items()]).any(dim=0)
    errs, inside_errs = {}, {}
    for k, e in per_env.items():
        errs[k] = float(e.max())
        inside_errs[k] = float(e[~over].max()) if bool((~over).any()) else float("nan")
        print(f"gen_step parity {label} {k}: max|kernel - plain| = {errs[k]:.3e} "
              f"over all envs, {inside_errs[k]:.3e} over the {int((~over).sum())} envs within "
              f"tolerance (tolerance {GEN_TOLERANCE[k]:.0e}; this field within it in "
              f"{int((e <= GEN_TOLERANCE[k]).sum())}/{e.numel()} envs)")
    for k, (med_bound, p90_bound) in GEN_MULTI_FRAME_BOUNDS.items():
        med, p90 = float(per_env[k].median()), float(per_env[k].quantile(0.9))
        print(f"gen_step parity {label} {k}: per-env median {med:.3e} "
              f"(bound {med_bound:.0e}), p90 {p90:.3e} (bound {p90_bound:.0e})")
        if med >= med_bound or p90 >= p90_bound:
            raise AssertionError(f"gen_step {k} per-env errors beyond the multi-frame bounds")
    n = over.numel()
    identical = int(torch.stack([(out[k] == ref[k]).reshape(n, -1).all(dim=1)
                                 for k in per_env]).all(dim=0).sum())
    print(f"gen_step parity {label}: {identical}/{n} envs bit-identical to the plain version")
    idx = over.nonzero().flatten()
    outliers = len(idx)
    print(f"gen_step parity {label}: {outliers} outlier envs of {over.numel()} "
          f"(at most {GEN_MAX_OUTLIERS} allowed): {idx.tolist()}")
    if outliers > GEN_MAX_OUTLIERS:
        raise AssertionError(f"gen_step disagrees with its plain version in {outliers} envs: "
                             f"{errs}")
    if outliers:
        decided = gen_rounding_decided(sys_, ins, n_frames, idx, out, gen)
        print(f"gen_step parity: the plain version reproduces the kernel from input noise of "
              f"relative size {ROUNDING_NOISE} in {int(decided.sum())}/{outliers} outlier envs")
        if not bool(decided.all()):
            raise AssertionError(f"gen_step disagrees with its plain version in envs "
                                 f"{idx[~decided].tolist()}, beyond rounding: {errs}")
    return errs, inside_errs, outliers, identical


def gen_bound(sys_, ins, n_frames):
    """(bound_ms, bound_by, ops, bytes) of one gen_step launch on `ins`: the
    plain version's operations on these inputs (OpCount) at the fp32 rate,
    against its inputs and outputs (one float each per env) and the scene
    table at the HBM rate."""
    n = ins[0].shape[0]
    counter = OpCount()
    with counter:
        gen_kernels.gen_step_plain(sys_, *ins, n_frames)
    n_bytes = (4 * n * (sum(x[0].numel() for x in ins) + sum(
        int(np.prod(s)) for s in gen_kernels.out_shapes(sys_).values()))
        + gen_kernels.pack_tables(sys_).nbytes)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = counter.ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", \
        counter.ops, n_bytes


def ptxas_figures(report):
    """Registers, stack frame and spill bytes from a ptxas report."""
    regs = re.search(r"Used (\d+) registers", report)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", report)
    return {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
            "spill_store_bytes": int(frame.group(2)), "spill_load_bytes": int(frame.group(3))}


def gen_launch_report(name, sys_, batches):
    """The generalized step's launch for a scene: ptxas's figures, shared
    memory per env and per block, and, per batch size, envs per block,
    resident blocks per SM (the CUDA runtime's occupancy) and waves."""
    dev = torch.device("cuda", torch.cuda.current_device())
    p = gen_kernels.plan(sys_)
    attrs = gen_kernels.kernel_attributes(sys_, dev)
    rec = {**ptxas_figures(gen_kernels.ptxas_report(sys_)),
           "local_bytes_per_thread": attrs["local_bytes"],
           "smem_bytes_per_env": gen_kernels.workspace_bytes(p),
           "smem_bytes_fixed_per_block": gen_kernels.block_fixed_bytes(p),
           "max_envs_per_block": gen_kernels.max_envs_per_block(p)}
    for n in batches:
        e = gen_kernels.launch_envs_per_block(sys_, dev, n)
        blocks, threads, smem = gen_kernels.launch_geometry(p, n, e)
        resident = gen_kernels.resident_blocks(sys_, dev, e)
        rec[f"at_{n}"] = {"envs_per_block": e, "threads_per_block": threads,
                          "smem_bytes_per_block": smem, "blocks": blocks,
                          "resident_blocks_per_sm": resident,
                          "resident_envs_per_sm": resident * e,
                          "waves": blocks / (attrs["sms"] * resident)}
    print(f"gen_step launch {name}: {rec['registers']} registers, stack {rec['stack_bytes']} B, "
          f"spills {rec['spill_store_bytes']}/{rec['spill_load_bytes']} B; shared memory "
          f"{rec['smem_bytes_per_env']} B per env + {rec['smem_bytes_fixed_per_block']} B per "
          f"block; " + "; ".join(
              f"{n} envs: {r['envs_per_block']} per block ({r['smem_bytes_per_block']} B), "
              f"{r['resident_blocks_per_sm']} blocks ({r['resident_envs_per_sm']} envs) resident "
              f"per SM, {r['blocks']} blocks = {r['waves']:.2f} waves"
              for n, r in ((n, rec[f"at_{n}"]) for n in batches)))
    return rec


def v2_parity(name, env, gen):
    """gen_step against its plain version for a v2 env at its n_frames, from
    a reset and, with floor contacts, from a reset with the torso lowered
    into contact.  Returns {label: gen_max_errors(...)} and the share of
    envs in contact at the lowered start (None without contacts)."""
    bare = env.unwrapped
    n, n_frames = bare.batch_size, bare._n_frames
    act = lambda: torch.rand((n, bare.action_size), generator=gen, device=DEVICE) * 2 - 1
    ps = env.reset(gen).pipeline_state
    label = f"{name} {n_frames} frame(s), reset"
    checks = {label: gen_max_errors(bare.sys, (ps.q, ps.qd, ps.mass_mx_inv, act()), n_frames,
                                    gen, label)}
    if name not in V2_CONTACT_ENVS:
        return checks, None
    # rootz is q[1]: lower each env until its lowest contact point touches
    # the floor, then by up to V2_LOWER more
    clearance = -ps.contact.penetration.amax(dim=1)
    q = ps.q.clone()
    q[:, 1] -= clearance + torch.rand(n, generator=gen, device=DEVICE) * V2_LOWER
    low = bare.pipeline_init(q, ps.qd)
    share = float((low.contact.penetration > 0).any(dim=1).float().mean())
    print(f"gen_step parity state: {name}, {n} envs from reset, torso lowered, {share:.3f} "
          f"in contact")
    label = f"{name} {n_frames} frame(s), lowered"
    checks[label] = gen_max_errors(bare.sys, (low.q, low.qd, low.mass_mx_inv, act()), n_frames,
                                   gen, label)
    return checks, share


def v2_main_path(name, tag):
    """V2_ENV_STEPS env.step calls of create(name, batch_size=N_ENVS) with
    exactly one gen_step launch each; then the kernel, its plain version
    and its bound on the last state.  Returns the env's record."""
    env = v2_envs.create(name, episode_length=1000, batch_size=N_ENVS)
    bare = env.unwrapped
    state = env.reset(torch.Generator(device=DEVICE).manual_seed(1))
    act_gen = torch.Generator(device=DEVICE).manual_seed(2)
    act = lambda: torch.rand((N_ENVS, bare.action_size), generator=act_gen, device=DEVICE) * 2 - 1
    warm = 10
    gen_kernels.gen_step_soa.launches = 0
    for i in range(V2_ENV_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state = env.step(state, act())
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (V2_ENV_STEPS - warm)
    launches = gen_kernels.gen_step_soa.launches
    if launches != V2_ENV_STEPS:
        raise AssertionError(f"{V2_ENV_STEPS} {name} env steps made {launches} gen_step launches")
    if not bool(torch.isfinite(state.obs).all()):
        raise AssertionError(f"non-finite {name} observations")
    done = float(state.done.mean())
    print(f"main path v2 {name}: {V2_ENV_STEPS} env.step calls, {launches} gen_step launches, "
          f"obs {tuple(state.obs.shape)} finite, done fraction {done:.4f}")
    ps = state.pipeline_state
    ins = (ps.q, ps.qd, ps.mass_mx_inv, act())
    soa = tuple(x.reshape(N_ENVS, -1).t().contiguous() for x in ins)
    n_frames = bare._n_frames
    ms = cuda_ms(lambda: gen_kernels.gen_step_soa(bare.sys, *soa, n_frames), 50, 5)
    plain_ms = cuda_ms(lambda: gen_kernels.gen_step_plain(bare.sys, *ins, n_frames), 1, 1)
    bound_ms, bound_by, ops, n_bytes = gen_bound(bare.sys, ins, n_frames)
    print(f"timing {tag}: v2 {name}: env.step {step_s * 1e3:.4f} ms/step, "
          f"{N_ENVS / step_s:.1f} env-steps/s (host clock, {V2_ENV_STEPS - warm} steps); gen_step "
          f"{ms:.4f} ms/launch ({n_frames} frames), plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.5f} ms by {bound_by} ({ops} ops, {n_bytes} bytes)")
    return {"n_frames": n_frames, "launches": launches,
            "launches_per_env_step": launches / V2_ENV_STEPS,
            "done_fraction": done, "env_step_ms": step_s * 1e3,
            "env_steps_per_s": N_ENVS / step_s, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops, "bytes": n_bytes}


# ---------------------------------------------------------------------------
# fused MLP kernels
# ---------------------------------------------------------------------------


def chain_inputs(name, rows, seed=0):
    """A chain's input, lecun-uniform weights, small biases and an output
    gradient of a mean loss (1 / rows scale), on the card."""
    dims = CHAINS[name]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((rows, dims[0]), generator=gen, device=DEVICE)
    ws = [(torch.rand((a, b), generator=gen, device=DEVICE) * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn((b,), generator=gen, device=DEVICE) * 0.1 for b in dims[1:]]
    g = torch.randn((rows, dims[-1]), generator=gen, device=DEVICE) / rows
    return dims, x, ws, bs, g


def check_chain(name, rows, bf16):
    """Kernel against plain version, forward and backward; raises on any
    output outside the tolerance.  Returns {"fwd"|"bwd": error summary}."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    y = fused_mlp.chain_fwd(x, ws, bs, "swish", bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x, ws, bs, g, "swish", bf16)
    torch.cuda.synchronize(DEVICE)
    y_p = fused_mlp.chain_fwd_plain(x, ws, bs, "swish", bf16)
    pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x, ws, bs, g, "swish", bf16)
    outputs = {
        "fwd": [("y", y, y_p)],
        "bwd": [("dx", dx, pdx)] + [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, pdws))]
        + [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, pdbs))],
    }
    summary = {}
    for kind, pairs in outputs.items():
        worst, max_err, rel = 0.0, 0.0, 0.0
        for label, got, want in pairs:
            err = (got - want).abs()
            if bf16:
                frac = float(err.max() / (BF16_REL * want.abs().max()))
            else:
                rtol, atol = F32_TOL[kind]
                frac = float((err / (atol + rtol * want.abs())).max())
            if frac > 1:
                raise AssertionError(f"fused_mlp {kind} {name}@{rows} {'bf16' if bf16 else 'f32'}: "
                                     f"{label} max |kernel - plain| {float(err.max()):.3e} is "
                                     f"{frac:.2f}x the tolerance")
            worst = max(worst, frac)
            max_err = max(max_err, float(err.max()))
            rel = max(rel, float(err.mean() / want.abs().mean()))
        summary[kind] = {"max_abs_err": max_err, "max_mean_rel_err": rel,
                         "fraction_of_tolerance": worst}
    return summary


def chain_bound(dims, rows, bf16, backward):
    """(bound_ms, bound_by, ops, bytes) of one chain call.

    Matmul operations at the bf16 tensor-core or the fp32 rate; elementwise
    ones (bias add 1, swish 4, swish' 6 and its product 1, db's sum 1 per
    element) at the fp32 rate.  Bytes: each input read once, each output
    written once, float32.  The backward recomputes the forward but its last
    layer, then runs dW and dx for every layer."""
    pairs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    outs, hidden = sum(dims[1:]), sum(dims[1:-1])
    if backward:
        mm = 2 * rows * (sum(pairs[:-1]) + 2 * sum(pairs))
        elem = rows * ((outs - dims[-1]) + 4 * hidden + 7 * hidden + outs)
        n_bytes = 4 * (2 * rows * dims[0] + rows * dims[-1] + 2 * (sum(pairs) + outs))
    else:
        mm = 2 * rows * sum(pairs)
        elem = rows * (outs + 4 * hidden)
        n_bytes = 4 * (rows * dims[0] + sum(pairs) + outs + rows * dims[-1])
    ops_ms = (mm / (BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S) + elem / FP32_OPS_PER_S) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(ops_ms, bytes_ms), bound_by, mm + elem, n_bytes


def time_chain(name, rows, bf16):
    """ms per call of each kernel and of the same chain as F.linear calls
    (cuBLAS, a yardstick) in the same precision, replayed from a CUDA graph
    (GRAPH_CALLS calls per graph: the card's time) and issued by the host
    (CUDA events over back-to-back calls: the wrapper's host cost
    included, "_host"), and of the plain versions, host-issued.  The
    cuBLAS backward replayed is its forward + autograd backward graph less
    its forward graph (a backward captures only beside its forward)."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    fwd = lambda *_: fused_mlp.chain_fwd(x, ws, bs, "swish", bf16)
    bwd = lambda *_: fused_mlp.chain_bwd(x, ws, bs, g, "swish", bf16)
    t = {
        "fwd": probe.graph_us(fwd, GRAPH_CALLS) / 1e3,
        "bwd": probe.graph_us(bwd, GRAPH_CALLS) / 1e3,
        "fwd_host": cuda_ms(fwd, 200, 20),
        "bwd_host": cuda_ms(bwd, 200, 20),
        "plain_fwd": cuda_ms(lambda: fused_mlp.chain_fwd_plain(x, ws, bs, "swish", bf16), 50, 5),
        "plain_bwd": cuda_ms(lambda: fused_mlp.chain_bwd_plain(x, ws, bs, g, "swish", bf16),
                             50, 5),
    }
    dt = torch.bfloat16 if bf16 else torch.float32
    wl = [w.t().contiguous().to(dt).requires_grad_() for w in ws]
    bl = [b.to(dt).requires_grad_() for b in bs]
    xl, gl = x.to(dt).requires_grad_(), g.to(dt)

    def linear_chain(h):
        for i, (w, b) in enumerate(zip(wl, bl)):
            h = F.linear(h, w, b)
            if i < len(wl) - 1:
                h = F.silu(h)
        return h

    def cublas_fwd(*_):
        with torch.no_grad():
            return linear_chain(xl)

    def cublas_fwd_bwd(*_):
        return torch.autograd.grad(linear_chain(xl), [xl, *wl, *bl], gl)

    t["cublas_fwd"] = probe.graph_us(cublas_fwd, GRAPH_CALLS) / 1e3
    t["cublas_bwd"] = probe.graph_us(cublas_fwd_bwd, GRAPH_CALLS) / 1e3 - t["cublas_fwd"]
    t["cublas_fwd_host"] = cuda_ms(cublas_fwd, 200, 20)
    y = linear_chain(xl)
    t["cublas_bwd_host"] = cuda_ms(
        lambda: torch.autograd.grad(y, [xl, *wl, *bl], gl, retain_graph=True), 200, 20)
    return t


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def recipe(name="ant"):
    return dict(DEFAULT_PPO_PARAMS[name])


def env_steps_per_training_step(p):
    return p["batch_size"] * p["unroll_length"] * p["num_minibatches"] * p["action_repeat"]


def launch_plan(p):
    """(rollout env steps, minibatch steps) per training step, and eval env
    steps, of a recipe."""
    return (p["batch_size"] * p["num_minibatches"] // p["num_envs"] * p["unroll_length"],
            p["num_updates_per_batch"] * p["num_minibatches"],
            p["episode_length"] // p["action_repeat"])


def expected_launches(p, steps):
    """(fwd, bwd, pbd_step) launches of `steps` training steps and one
    evaluation: the rollout runs the policy once per env step; each
    minibatch step runs the policy, the value and the bootstrap value
    forward, and the policy and value backward (GAE detaches the bootstrap
    value); the physics runs action_repeat times per env step."""
    rollout, sgd, eval_steps = launch_plan(p)
    return (steps * (rollout + 3 * sgd) + eval_steps, steps * 2 * sgd,
            (steps * rollout + eval_steps) * p["action_repeat"])


class InitRecorder:
    """A network factory that keeps the networks it makes and a copy of the
    parameters each network's `init` returns."""

    def __init__(self):
        self.networks, self.initial = None, {}

    def factory(self, *args, **kwargs):
        self.networks = ppo_networks.make_ppo_networks(*args, **kwargs)
        for side in ("policy", "value"):
            net = getattr(self.networks, f"{side}_network")
            net.init = self._recording(side, net.init)
        return self.networks

    def _recording(self, side, init):
        def wrapped(generator):
            params = init(generator)
            self.initial[side] = {k: v.detach().clone() for k, v in params.items()}
            return params
        return wrapped


def v2_ant(batch_size, device):
    """The bare v2 ant: the factory PPO trains on v2."""
    return v2_envs.get_environment("ant", batch_size=batch_size, device=device)


def run_ppo(fused, steps, environment="ant", preset="ant", **kw):
    p = recipe(preset)
    p.update(num_timesteps=steps * env_steps_per_training_step(p), num_evals=1)
    p.update(kw)
    return ppo.train(environment, num_eval_envs=PPO_EVAL_ENVS, use_fused_kernel=fused, seed=0,
                     device=DEVICE, **p)


def check_ppo_run(label, metrics, recorder, policy_params, launches, want):
    """Raises unless the launch counts are `want`, the losses and the eval
    reward finite, every parameter moved and the returned policy params
    those trained.  Returns the smallest max change of a parameter."""
    if launches != want:
        raise AssertionError(f"{label} launches {launches}, expected {want}")
    for key in ("training/total_loss", "training/policy_loss", "training/v_loss",
                "training/entropy_loss", "eval/episode_reward"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"{label} {key} = {metrics[key]}")
    moved = {}
    for side in ("policy", "value"):
        now = dict(getattr(recorder.networks, f"{side}_network").mlp.named_parameters())
        for k, before in recorder.initial[side].items():
            moved[f"{side}.{k}"] = float((now[k].detach() - before).abs().max())
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"{label}: parameters that did not change: "
                             f"{[k for k, v in moved.items() if not v > 0]}")
    if any(not torch.equal(policy_params[k], v.detach()) for k, v in
           recorder.networks.policy_network.mlp.named_parameters()):
        raise AssertionError(f"{label}: train returned other policy params than it trained")
    return min(moved.values())


def profile_training_step(fused, environment="ant", preset="ant"):
    """Device time, device-op count and top kernels of the second of two
    training steps (the host range "ppo/training_step", which ends in a
    synchronise), and the host time of its rollout and SGD ranges.

    The episode is cut to PROFILE_EPISODE steps so that the run's one
    evaluation stays short; a training step does the same work at any
    episode length (auto-reset runs every step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_ppo(fused, steps=2, environment=environment, preset=preset,
                episode_length=PROFILE_EPISODE)
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = lambda name: sorted((e for e in events if e.name == name and e.device_type == cpu),
                                 key=lambda e: e.time_range.start)
    step = ranges("ppo/training_step")[-1]
    t0, t1 = step.time_range.start, step.time_range.end
    inside = lambda e: t0 <= e.time_range.start <= t1
    # the profiler mirrors each record_function range (ours, the optimizer's)
    # on the device timeline: those are not device work
    ops = [e for e in events if e.device_type == cuda and inside(e)
           and not getattr(e, "is_user_annotation", False) and "/" not in e.name
           and "#" not in e.name]
    by_name = {}
    for e in ops:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    host = {name.split("/")[1]: sum(e.time_range.elapsed_us() for e in ranges(name) if inside(e))
            for name in ("ppo/rollout", "ppo/sgd")}
    host_by_name = {}
    for e in events:
        if e.device_type == cpu and inside(e) and not getattr(e, "is_user_annotation", False):
            n, us = host_by_name.get(e.name, (0, 0.0))
            host_by_name[e.name] = (n + 1, us + e.self_cpu_time_total)
    return {
        "step_us": t1 - t0,
        "device_us": sum(us for _, us in by_name.values()),
        "device_ops": len(ops),
        "host_us": host,
        "top": sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8],
        "host_top": sorted(host_by_name.items(), key=lambda kv: -kv[1][1])[:8],
    }


def print_profile(tag, label, mode, prof):
    """Prints a profile_training_step result; returns it."""
    if not prof["device_us"]:
        print(f"profile {tag}: {label}fused_mlp {mode}: no device time recorded (not measured)")
        return prof
    print(f"profile {tag}: {label}fused_mlp {mode}: one training step "
          f"{prof['step_us'] / 1e3:.1f} ms (host), of it rollout "
          f"{prof['host_us']['rollout'] / 1e3:.1f} ms and sgd {prof['host_us']['sgd'] / 1e3:.1f} "
          f"ms; device busy {prof['device_us'] / 1e3:.1f} ms "
          f"({prof['device_us'] / prof['step_us']:.3f}), {prof['device_ops']} device ops "
          f"(kernels, copies)")
    for kname, (n, us) in prof["top"]:
        print(f"  {us / 1e3:9.3f} ms/step  {n:6d}/step  {kname[:90]}")
    print(f"profile {tag}: {label}fused_mlp {mode}: host self time by op in that step:")
    for kname, (n, us) in prof["host_top"]:
        print(f"  {us / 1e3:9.3f} ms/step  {n:6d}/step  {kname[:90]}")
    return prof


def humanoid_paths(tag, phase, h_envs, checks, fused_plans, times, bounds):
    """The v1 humanoid phases: the PBD kernel's spherical group against the
    twin per scene at N_ENVS envs (from a reset and after 10 twin steps),
    the main paths (env.step of humanoid, humanoid_legacy and
    humanoidstandup, exact launch counts), the kernel's timings and bound,
    the fused MLP kernels against their plain versions and timed at the
    humanoid recipe's shapes (added to `checks`, `fused_plans`, `times` and
    `bounds`), and PPO at the humanoid recipe for PPO_HUMANOID_STEPS
    training steps and one evaluation, with exact launch counts."""
    # -- v1 humanoid: the spherical group, at 4096 envs -----------------------------
    device = DEVICE
    phase("humanoid: pbd_step parity")
    h_scene = {}
    for name, h_env in h_envs.items():
        h_sys = h_env.sys
        gen = torch.Generator(device=device).manual_seed(0)
        rand_act = lambda: torch.rand((N_ENVS, h_env.action_size), generator=gen,
                                      device=device) * 2 - 1
        qp = h_env.reset(gen).qp
        checks_h = {}
        for label in ("reset", "after 10 twin steps"):
            if label != "reset":
                for _ in range(10):
                    qp, _ = kernels.pbd_step_plain(h_sys, qp, rand_act())
            act = rand_act()
            share = contact_share(h_sys, qp, act)
            print(f"parity state: {name}, {N_ENVS} envs, {label}, {share:.3f} in contact")
            errs_h, inside_h, outliers_h = max_errors(h_sys, qp, act, gen, f"{name} {label} ")
            checks_h[label] = {"max_abs_err_by_field": errs_h,
                               "max_abs_err_within_tolerance_by_field": inside_h,
                               "outlier_envs_decided_by_rounding": outliers_h,
                               "contact_share": share}
        h_scene[name] = {"sys": h_sys, "qp": qp, "act": act, "checks": checks_h}

    phase("humanoid: main paths")
    h_main = {}
    for name, steps in HUMANOID_ENV_STEPS.items():
        h_env, h_state, h_act_gen, h_main[name] = v1_main_path(
            tag, name, steps, HUMANOID_OBS, warm=20 if steps == MAIN_STEPS else 10)
        if name == "humanoid":
            h_state, h_main[name]["profile"] = profile_env_step(tag, name, h_env, h_state,
                                                                h_act_gen)

    phase("humanoid: pbd_step timings")
    for name, r in h_scene.items():
        h_sys, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(h_sys, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(h_sys, qp, act), reps=10,
                                warmup=2)
        r["ms_by_envs"] = pbd_timings(tag, h_sys, qp, act, b[0] / N_ENVS, name)
        print(f"bound {tag}: pbd_step {name} at {N_ENVS} envs: {b[3]} bytes -> {b[4]:.5f} ms at "
              f"3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> {b[5]:.5f} ms at 67 "
              f"TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("humanoid: fused_mlp parity and timings")
    for name, rows in HUMANOID_PARITY_SHAPES:
        for mode in ("bf16", "f32"):
            checks[name, rows, mode] = check_chain(name, rows, mode == "bf16")
            for kind, r in checks[name, rows, mode].items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{r['max_abs_err']:.3e}, mean|err|/mean|plain| up to "
                      f"{r['max_mean_rel_err']:.3e}, {r['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")
        for kind in ("fwd", "bwd"):
            fused_plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(CHAINS[name]), rows, device, kind == "bwd").items() if k != "scratch"}
            print(f"launch fused_mlp_{kind} {name}@{rows} bf16: {fused_plans[kind, name, rows]}")
    for name, rows in HUMANOID_TIMING_SHAPES:
        for mode in ("bf16", "f32") if rows == 10240 else ("bf16",):
            times[name, rows, mode] = t = time_chain(name, rows, mode == "bf16")
            for kind in ("fwd", "bwd"):
                bounds[kind, name, rows, mode] = b = chain_bound(
                    CHAINS[name], rows, mode == "bf16", kind == "bwd")
                print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} {mode}: kernel "
                      f"{t[kind]:.4f} ms graph-replayed ({t[kind + '_host']:.4f} host-issued), "
                      f"plain {t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                      f"{t['cublas_' + kind]:.4f} ms graph-replayed "
                      f"({t['cublas_' + kind + '_host']:.4f} host-issued); bound {b[0]:.5f} ms by "
                      f"{b[1]} ({b[2]:.4g} ops, {b[3]} bytes)")

    phase("humanoid: PPO")
    p_h = recipe("humanoid")
    rollout_h, sgd_h, _ = launch_plan(p_h)
    per_step_h = {"pbd_step": rollout_h * p_h["action_repeat"],
                  "fused_mlp_fwd": rollout_h + 3 * sgd_h, "fused_mlp_bwd": 2 * sgd_h}
    if per_step_h != {"pbd_step": 160, "fused_mlp_fwd": 928, "fused_mlp_bwd": 512}:
        raise AssertionError(f"humanoid recipe launches per training step {per_step_h}")
    want_h = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_h, PPO_HUMANOID_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), h_ppo = run_ppo(True, PPO_HUMANOID_STEPS, environment="humanoid",
                                           preset="humanoid", network_factory=recorder.factory)
    torch.cuda.synchronize()
    h_ppo_s = time.perf_counter() - t0
    h_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO humanoid", h_ppo, recorder, policy_params, h_launches, want_h)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (HUMANOID_OBS, 34):
        raise AssertionError(f"the humanoid policy maps {widths[0]} inputs to {widths[1]}")
    h_fused_ms = {
        "fwd": rollout_h * times["policy_humanoid", 2048, "bf16"]["fwd"] + sgd_h * sum(
            times[c + "_humanoid", r, "bf16"]["fwd"]
            for c, r in (("policy", 10240), ("value", 10240), ("value", 1024))),
        "bwd": sgd_h * sum(times[c + "_humanoid", 10240, "bf16"]["bwd"]
                           for c in ("policy", "value")),
    }
    print(f"main path PPO humanoid: {PPO_HUMANOID_STEPS} training steps at the humanoid recipe "
          f"(num_envs {p_h['num_envs']}, batch {p_h['batch_size']} x {p_h['num_minibatches']} "
          f"minibatches, unroll {p_h['unroll_length']}, {p_h['num_updates_per_batch']} updates) "
          f"+ one eval of {PPO_EVAL_ENVS} envs in {h_ppo_s:.1f} s; launches {h_launches} (as "
          f"expected; per training step {per_step_h}); total_loss "
          f"{h_ppo['training/total_loss']:.5g}, eval/episode_reward "
          f"{h_ppo['eval/episode_reward']:.5g}; every parameter moved (smallest max change "
          f"{moved:.3e})")
    print(f"timing {tag}: PPO humanoid training env-steps/s over step 2 (host clock, fused_mlp "
          f"on): {h_ppo['training/sps_after_first']:.1f}; fused device ms per training step "
          f"(graph-replayed times x launches): fwd {h_fused_ms['fwd']:.3f}, bwd "
          f"{h_fused_ms['bwd']:.3f}")
    return {"scene": h_scene, "main": h_main, "launches": h_launches, "ppo": h_ppo,
            "per_step": per_step_h, "fused_ms": h_fused_ms, "seconds": h_ppo_s}


def capcap_paths(tag, phase, c_envs, checks, fused_plans, times, bounds):
    """The v1 halfcheetah and pusher phases (the PBD kernel's two-way
    capsule-capsule group, PBD_CAPCAP): the kernel against the twin per
    scene at N_ENVS envs from a reset, after 10 twin steps and with the
    scene's capsule-capsule pairs overlapping (capcap_state), over one pass
    and over the whole step, each by the rule pbd_parity.RULES names
    (hold_capcap); the main paths (env.step of
    halfcheetah, profiled, and pusher, exact launch counts), the kernel's
    timings and bound, the fused MLP kernels against their plain versions
    and timed at the halfcheetah recipe's shapes (added to `checks`,
    `fused_plans`, `times` and `bounds`), and PPO at the halfcheetah recipe
    for PPO_HALFCHEETAH_STEPS training steps and one evaluation, with exact
    launch counts."""
    device = DEVICE
    phase("v1 halfcheetah, v1 pusher: pbd_step parity")
    c_scene = {}
    for name, c_env in c_envs.items():
        c_sys, label = c_env.sys, CAPCAP_LABEL[name]
        gen = torch.Generator(device=device).manual_seed(0)
        rand_act = lambda: torch.rand((N_ENVS, c_env.action_size), generator=gen,
                                      device=device) * 2 - 1
        reset = c_env.reset(gen).qp
        settled = reset
        for _ in range(10):
            settled, _ = kernels.pbd_step_plain(c_sys, settled, rand_act())
        states = dict(zip(STATES, ((reset, rand_act()), (settled, rand_act()),
                                   capcap_state(name, c_env.unwrapped, N_ENVS, 1, device))))
        checks_c = {}
        for state, (qp, act) in states.items():
            share, cc_share = contact_share(c_sys, qp, act), capcap_share(c_sys, qp)
            print(f"parity state: {label}, {N_ENVS} envs, {state}, {share:.3f} in contact, "
                  f"{cc_share:.3f} with a capsule-capsule pair overlapping; one pass by "
                  f"{RULES[name][state][0]}, the whole step by {RULES[name][state][1]}")
            checks_c[state] = {**hold_capcap(name, state, c_sys, qp, act, gen,
                                             f"{label} {state} "),
                               "contact_share": share, "capcap_share": cc_share}
        c_scene[name] = {"sys": c_sys, "qp": settled, "act": states[STATES[1]][1],
                         "checks": checks_c}

    phase("v1 halfcheetah, v1 pusher: main paths")
    c_main = {}
    for name, steps in CAPCAP_ENV_STEPS.items():
        c_env, c_state, c_act_gen, c_main[name] = v1_main_path(
            tag, name, steps, CAPCAP_OBS[name], warm=20 if steps == MAIN_STEPS else 10,
            label=CAPCAP_LABEL[name])
        if name == "halfcheetah":
            c_state, c_main[name]["profile"] = profile_env_step(tag, CAPCAP_LABEL[name], c_env,
                                                                c_state, c_act_gen)

    phase("v1 halfcheetah, v1 pusher: pbd_step timings")
    for name, r in c_scene.items():
        c_sys, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(c_sys, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(c_sys, qp, act), reps=5,
                                warmup=1)
        r["ms_by_envs"] = pbd_timings(tag, c_sys, qp, act, b[0] / N_ENVS, CAPCAP_LABEL[name])
        print(f"bound {tag}: pbd_step {CAPCAP_LABEL[name]} at {N_ENVS} envs: {b[3]} bytes -> "
              f"{b[4]:.5f} ms at 3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> "
              f"{b[5]:.5f} ms at 67 TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("v1 halfcheetah: fused_mlp parity and timings")
    for name, rows in HALFCHEETAH_PARITY_SHAPES:
        for mode in ("bf16", "f32"):
            checks[name, rows, mode] = check_chain(name, rows, mode == "bf16")
            for kind, r in checks[name, rows, mode].items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{r['max_abs_err']:.3e}, mean|err|/mean|plain| up to "
                      f"{r['max_mean_rel_err']:.3e}, {r['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")
        for kind in ("fwd", "bwd"):
            fused_plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(CHAINS[name]), rows, device, kind == "bwd").items() if k != "scratch"}
            print(f"launch fused_mlp_{kind} {name}@{rows} bf16: {fused_plans[kind, name, rows]}")
    for name, rows in HALFCHEETAH_TIMING_SHAPES:
        for mode in ("bf16", "f32") if rows == 10240 else ("bf16",):
            times[name, rows, mode] = t = time_chain(name, rows, mode == "bf16")
            for kind in ("fwd", "bwd"):
                bounds[kind, name, rows, mode] = b = chain_bound(
                    CHAINS[name], rows, mode == "bf16", kind == "bwd")
                print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} {mode}: kernel "
                      f"{t[kind]:.4f} ms graph-replayed ({t[kind + '_host']:.4f} host-issued), "
                      f"plain {t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                      f"{t['cublas_' + kind]:.4f} ms graph-replayed "
                      f"({t['cublas_' + kind + '_host']:.4f} host-issued); bound {b[0]:.5f} ms by "
                      f"{b[1]} ({b[2]:.4g} ops, {b[3]} bytes)")

    phase("v1 halfcheetah: PPO")
    p_c = recipe("halfcheetah")
    rollout_c, sgd_c, _ = launch_plan(p_c)
    per_step_c = {"pbd_step": rollout_c * p_c["action_repeat"],
                  "fused_mlp_fwd": rollout_c + 3 * sgd_c, "fused_mlp_bwd": 2 * sgd_c}
    if per_step_c != {"pbd_step": 160, "fused_mlp_fwd": 928, "fused_mlp_bwd": 512}:
        raise AssertionError(f"halfcheetah recipe launches per training step {per_step_c}")
    if env_steps_per_training_step(p_c) != 327_680:
        raise AssertionError(f"halfcheetah recipe env steps per training step "
                             f"{env_steps_per_training_step(p_c)}")
    want_c = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_c, PPO_HALFCHEETAH_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), c_ppo = run_ppo(True, PPO_HALFCHEETAH_STEPS, environment="halfcheetah",
                                           preset="halfcheetah", network_factory=recorder.factory)
    torch.cuda.synchronize()
    c_ppo_s = time.perf_counter() - t0
    c_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO v1 halfcheetah", c_ppo, recorder, policy_params, c_launches,
                          want_c)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (CAPCAP_OBS["halfcheetah"], 12):
        raise AssertionError(f"the halfcheetah policy maps {widths[0]} inputs to {widths[1]}")
    c_fused_ms = {
        "fwd": rollout_c * times["policy_halfcheetah", 2048, "bf16"]["fwd"] + sgd_c * sum(
            times[c + "_halfcheetah", r, "bf16"]["fwd"]
            for c, r in (("policy", 10240), ("value", 10240), ("value", 512))),
        "bwd": sgd_c * sum(times[c + "_halfcheetah", 10240, "bf16"]["bwd"]
                           for c in ("policy", "value")),
    }
    print(f"main path PPO v1 halfcheetah: {PPO_HALFCHEETAH_STEPS} training steps at the "
          f"halfcheetah recipe (num_envs {p_c['num_envs']}, batch {p_c['batch_size']} x "
          f"{p_c['num_minibatches']} minibatches, unroll {p_c['unroll_length']}, "
          f"{p_c['num_updates_per_batch']} updates) + one eval of {PPO_EVAL_ENVS} envs in "
          f"{c_ppo_s:.1f} s; launches {c_launches} (as expected; per training step "
          f"{per_step_c}); total_loss {c_ppo['training/total_loss']:.5g}, eval/episode_reward "
          f"{c_ppo['eval/episode_reward']:.5g}; every parameter moved (smallest max change "
          f"{moved:.3e})")
    print(f"timing {tag}: PPO v1 halfcheetah training env-steps/s over step 2 (host clock, "
          f"fused_mlp on): {c_ppo['training/sps_after_first']:.1f}; fused device ms per training "
          f"step (graph-replayed times x launches): fwd {c_fused_ms['fwd']:.3f}, bwd "
          f"{c_fused_ms['bwd']:.3f}")
    return {"scene": c_scene, "main": c_main, "launches": c_launches, "ppo": c_ppo,
            "per_step": per_step_c, "fused_ms": c_fused_ms, "seconds": c_ppo_s}


def force_paths(tag, phase, f_envs):
    """The phases of the v1 scenes without contacts (the PBD kernel's
    thruster group, PBD_FORCES: inverted_pendulum, inverted_double_pendulum,
    swimmer; its angle actuators, PBD_ANGLE: reacherangle; reacher): the
    kernel against the twin per scene at N_ENVS envs from a reset and after
    10 twin steps on the scene's physics actions (pbd_parity.physics_actions:
    inverted_pendulum's real 1-wide action, swimmer's 11 columns,
    reacherangle's targets past its joints' limits) by the rounding rule;
    the main paths (env.step of each, swimmer's profiled, exact launch
    counts); the kernel's timings and bound; and PPO at the reacher recipe
    (action_repeat 4) for PPO_REACHER_STEPS training steps and one
    evaluation, with exact launch counts.  A profile of its training step
    takes minutes of the profiler's processing (~137k device ops a step):
    scripts/profile_ppo_step.py runs it apart."""
    device = DEVICE
    phase("v1 thruster and angle-actuator scenes: pbd_step parity")
    f_scene = {}
    for name, f_env in f_envs.items():
        f_sys = f_env.sys
        gen = torch.Generator(device=device).manual_seed(7)
        checks_f = {}
        for state, (qp, act) in force_scene_states(name, f_env, N_ENVS, 0, device).items():
            print(f"parity state: {name}, {N_ENVS} envs, {state}, action {tuple(act.shape)}")
            errs_f, inside_f, outliers_f = max_errors(f_sys, qp, act, gen, f"{name} {state} ")
            checks_f[state] = {"max_abs_err_by_field": errs_f,
                               "max_abs_err_within_tolerance_by_field": inside_f,
                               "outlier_envs_decided_by_rounding": outliers_f,
                               "action_columns": act.shape[1]}
        f_scene[name] = {"sys": f_sys, "qp": qp, "act": act, "checks": checks_f}

    phase("v1 thruster and angle-actuator scenes: main paths")
    f_main = {}
    for name, steps in FORCE_ENV_STEPS.items():
        f_env, f_state, f_act_gen, f_main[name] = v1_main_path(
            tag, name, steps, FORCE_OBS[name], warm=20 if steps == MAIN_STEPS else 10)
        if name == "swimmer":
            f_state, f_main[name]["profile"] = profile_env_step(tag, name, f_env, f_state,
                                                                f_act_gen)

    phase("v1 thruster and angle-actuator scenes: pbd_step timings")
    for name, r in f_scene.items():
        f_sys, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(f_sys, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(f_sys, qp, act), reps=5,
                                warmup=1)
        r["ms_by_envs"] = pbd_timings(tag, f_sys, qp, act, b[0] / N_ENVS, name)
        print(f"bound {tag}: pbd_step {name} at {N_ENVS} envs: {b[3]} bytes -> {b[4]:.5f} ms at "
              f"3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> {b[5]:.5f} ms at 67 "
              f"TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("v1 reacher: PPO")
    p_r = recipe("reacher")
    rollout_r, sgd_r, eval_r = launch_plan(p_r)
    per_step_r = {"pbd_step": rollout_r * p_r["action_repeat"],
                  "fused_mlp_fwd": rollout_r + 3 * sgd_r, "fused_mlp_bwd": 2 * sgd_r}
    if per_step_r != {"pbd_step": 800, "fused_mlp_fwd": 968, "fused_mlp_bwd": 512}:
        raise AssertionError(f"reacher recipe launches per training step {per_step_r}")
    if (env_steps_per_training_step(p_r), eval_r) != (1_638_400, 250):
        raise AssertionError(f"reacher recipe env steps per training step "
                             f"{env_steps_per_training_step(p_r)}, eval steps {eval_r}")
    want_r = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_r, PPO_REACHER_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), r_ppo = run_ppo(True, PPO_REACHER_STEPS, environment="reacher",
                                           preset="reacher", network_factory=recorder.factory)
    torch.cuda.synchronize()
    r_ppo_s = time.perf_counter() - t0
    r_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO reacher", r_ppo, recorder, policy_params, r_launches, want_r)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (FORCE_OBS["reacher"], 4):
        raise AssertionError(f"the reacher policy maps {widths[0]} inputs to {widths[1]}")
    print(f"main path PPO reacher: {PPO_REACHER_STEPS} training steps at the reacher recipe "
          f"(num_envs {p_r['num_envs']}, batch {p_r['batch_size']} x {p_r['num_minibatches']} "
          f"minibatches, unroll {p_r['unroll_length']}, action_repeat {p_r['action_repeat']}, "
          f"{p_r['num_updates_per_batch']} updates) + one eval of {PPO_EVAL_ENVS} envs in "
          f"{r_ppo_s:.1f} s; launches {r_launches} (as expected; per training step "
          f"{per_step_r}); total_loss {r_ppo['training/total_loss']:.5g}, eval/episode_reward "
          f"{r_ppo['eval/episode_reward']:.5g}; every parameter moved (smallest max change "
          f"{moved:.3e})")
    print(f"timing {tag}: PPO reacher training env-steps/s over step 2 (host clock, fused_mlp "
          f"on): {r_ppo['training/sps_after_first']:.1f}")
    return {"scene": f_scene, "main": f_main, "launches": r_launches, "ppo": r_ppo,
            "per_step": per_step_r, "seconds": r_ppo_s}


def grasp_paths(tag, phase, g_envs, checks, fused_plans, times, bounds):
    """The v1 grasp, acrobot and ur5e phases (the PBD kernel's one-way
    capsule-capsule lanes, PBD_CAPCAP_ONEWAY, and angle actuators on
    spherical joints, PBD_SPHERICAL_ANGLE; acrobot and ur5e on the revolute
    and torque code): grasp's kernel against the twin at N_ENVS envs from a
    reset and with its claw closed on the ball (pbd_parity.grasp_states),
    over one pass and over the whole step, each by the rule
    pbd_parity.RULES names; the twister (swimmer's torso thruster made
    one, pbd_parity.twister_swimmer) after 10 twin steps by the rounding
    rule; the main paths (env.step of grasp, profiled, acrobot and ur5e,
    exact launch counts); the kernel's timings and bound per scene; the
    fused MLP kernels against their plain versions and timed at the grasp
    recipe's shapes (added to `checks`, `fused_plans`, `times` and
    `bounds`); and PPO at the grasp recipe for PPO_GRASP_STEPS training
    steps and one evaluation, with exact launch counts."""
    device = DEVICE
    phase("v1 grasp: pbd_step parity")
    g_env = g_envs["grasp"]
    g_sys = g_env.sys
    gen = torch.Generator(device=device).manual_seed(7)
    checks_g = {}
    for state, (qp, act) in grasp_states(g_env.unwrapped, N_ENVS, 0, device).items():
        share, tips = contact_share(g_sys, qp, act), fingertips_on_ball(g_env.unwrapped, qp)
        print(f"parity state: grasp, {N_ENVS} envs, {state}, {share:.3f} in contact, {tips:.3f} "
              f"with all four fingertips on the ball; one pass by {RULES['grasp'][state][0]}, "
              f"the whole step by {RULES['grasp'][state][1]}")
        checks_g[state] = {**hold_capcap("grasp", state, g_sys, qp, act, gen, f"grasp {state} "),
                           "contact_share": share, "fingertips_on_ball": tips}
    g_scene = {"grasp": {"sys": g_sys, "qp": qp, "act": act, "checks": checks_g}}
    t_sys = twister_swimmer(device)
    t_env = envs.create("swimmer", episode_length=1000, batch_size=N_ENVS)
    t_qp, t_act = force_scene_states("swimmer", t_env, N_ENVS, 0, device, t_sys)[STATES[1]]
    print(f"parity state: swimmer_twister (swimmer's torso thruster made a twister), {N_ENVS} "
          f"envs, {STATES[1]}, action {tuple(t_act.shape)}")
    errs_t, inside_t, outliers_t = max_errors(t_sys, t_qp, t_act, gen, "swimmer_twister ")
    twister = {"max_abs_err_by_field": errs_t, "max_abs_err_within_tolerance_by_field": inside_t,
               "outlier_envs_decided_by_rounding": outliers_t}
    for name in ("acrobot", "ur5e"):
        env_ = g_envs[name]
        gen_ = torch.Generator(device=device).manual_seed(0)
        qp_ = env_.reset(gen_).qp
        act_ = lambda: torch.rand((N_ENVS, env_.action_size), generator=gen_, device=device) * 2 - 1
        for _ in range(10):
            qp_, _ = kernels.pbd_step_plain(env_.sys, qp_, act_())
        a_ = act_()
        print(f"parity state: {name}, {N_ENVS} envs, {STATES[1]}, action {tuple(a_.shape)}")
        e_, i_, o_ = max_errors(env_.sys, qp_, a_, gen, f"{name} {STATES[1]} ")
        g_scene[name] = {"sys": env_.sys, "qp": qp_, "act": a_, "checks": {STATES[1]: {
            "max_abs_err_by_field": e_, "max_abs_err_within_tolerance_by_field": i_,
            "outlier_envs_decided_by_rounding": o_}}}

    phase("v1 grasp, acrobot, ur5e: main paths")
    g_main = {}
    for name, steps in GRASP_ENV_STEPS.items():
        env_, state_, act_gen, g_main[name] = v1_main_path(
            tag, name, steps, GRASP_OBS[name], warm=20 if steps == MAIN_STEPS else 10)
        if name == "grasp":
            state_, g_main[name]["profile"] = profile_env_step(tag, name, env_, state_, act_gen)

    phase("v1 grasp, acrobot, ur5e: pbd_step timings")
    for name, r in g_scene.items():
        sys_, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(sys_, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=5, warmup=1)
        r["ms_by_envs"] = pbd_timings(tag, sys_, qp, act, b[0] / N_ENVS, name)
        print(f"bound {tag}: pbd_step {name} at {N_ENVS} envs: {b[3]} bytes -> {b[4]:.5f} ms at "
              f"3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> {b[5]:.5f} ms at 67 "
              f"TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("v1 grasp: fused_mlp parity and timings")
    for name, rows in GRASP_PARITY_SHAPES:
        for mode in ("bf16", "f32"):
            checks[name, rows, mode] = check_chain(name, rows, mode == "bf16")
            for kind, r in checks[name, rows, mode].items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{r['max_abs_err']:.3e}, mean|err|/mean|plain| up to "
                      f"{r['max_mean_rel_err']:.3e}, {r['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")
        for kind in ("fwd", "bwd"):
            fused_plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(CHAINS[name]), rows, device, kind == "bwd").items() if k != "scratch"}
    for name, rows in GRASP_TIMING_SHAPES:
        times[name, rows, "bf16"] = t = time_chain(name, rows, True)
        for kind in ("fwd", "bwd"):
            bounds[kind, name, rows, "bf16"] = b = chain_bound(CHAINS[name], rows, True,
                                                               kind == "bwd")
            print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} bf16: kernel {t[kind]:.4f} ms "
                  f"graph-replayed ({t[kind + '_host']:.4f} host-issued), plain "
                  f"{t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                  f"{t['cublas_' + kind]:.4f} ms graph-replayed; bound {b[0]:.5f} ms by {b[1]}")

    phase("v1 grasp: PPO")
    p_g = recipe("grasp")
    rollout_g, sgd_g, _ = launch_plan(p_g)
    per_step_g = {"pbd_step": rollout_g * p_g["action_repeat"],
                  "fused_mlp_fwd": rollout_g + 3 * sgd_g, "fused_mlp_bwd": 2 * sgd_g}
    if per_step_g != {"pbd_step": 80, "fused_mlp_fwd": 272, "fused_mlp_bwd": 128}:
        raise AssertionError(f"grasp recipe launches per training step {per_step_g}")
    if env_steps_per_training_step(p_g) != 163_840:
        raise AssertionError(f"grasp recipe env steps per training step "
                             f"{env_steps_per_training_step(p_g)}")
    want_g = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_g, PPO_GRASP_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), g_ppo = run_ppo(True, PPO_GRASP_STEPS, environment="grasp",
                                           preset="grasp", network_factory=recorder.factory)
    torch.cuda.synchronize()
    g_ppo_s = time.perf_counter() - t0
    g_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO grasp", g_ppo, recorder, policy_params, g_launches, want_g)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (GRASP_OBS["grasp"], 78):
        raise AssertionError(f"the grasp policy maps {widths[0]} inputs to {widths[1]}")
    g_fused_ms = {
        "fwd": rollout_g * times["policy_grasp", 2048, "bf16"]["fwd"] + sgd_g * sum(
            times[c + "_grasp", r, "bf16"]["fwd"]
            for c, r in (("policy", 5120), ("value", 5120), ("value", 256))),
        "bwd": sgd_g * sum(times[c + "_grasp", 5120, "bf16"]["bwd"] for c in ("policy", "value")),
    }
    print(f"main path PPO grasp: {PPO_GRASP_STEPS} training steps at the grasp recipe (num_envs "
          f"{p_g['num_envs']}, batch {p_g['batch_size']} x {p_g['num_minibatches']} minibatches, "
          f"unroll {p_g['unroll_length']}, {p_g['num_updates_per_batch']} updates) + one eval "
          f"of {PPO_EVAL_ENVS} envs in {g_ppo_s:.1f} s; launches {g_launches} (as expected; per "
          f"training step {per_step_g}); total_loss {g_ppo['training/total_loss']:.5g}, "
          f"eval/episode_reward {g_ppo['eval/episode_reward']:.5g}; every parameter moved "
          f"(smallest max change {moved:.3e})")
    print(f"timing {tag}: PPO grasp training env-steps/s over step 2 (host clock, fused_mlp on): "
          f"{g_ppo['training/sps_after_first']:.1f}; fused device ms per training step "
          f"(graph-replayed times x launches): fwd {g_fused_ms['fwd']:.3f}, bwd "
          f"{g_fused_ms['bwd']:.3f}")
    return {"scene": g_scene, "main": g_main, "launches": g_launches, "ppo": g_ppo,
            "per_step": per_step_g, "fused_ms": g_fused_ms, "seconds": g_ppo_s,
            "twister": twister}


def fetch_paths(tag, phase, b_envs, checks, fused_plans, times, bounds):
    """The v1 fetch, hopper and walker2d phases (the PBD kernel's one-way
    box-plane contacts: each box corner a capsule-plane lane of radius 0,
    eight to a lower leg; hopper and walker2d on the capsule-plane code):
    fetch's kernel against the twin at N_ENVS envs from a reset and with
    its feet on the ground (pbd_parity.fetch_states), hopper's and
    walker2d's from a reset and after 10 twin steps
    (pbd_parity.force_scene_states), over one pass and over the whole
    step, each by the rule pbd_parity.RULES names; the main paths
    (env.step of fetch, profiled, hopper and walker2d, exact launch
    counts); the kernel's timings and bound per scene; the fused MLP
    kernels against their plain versions and timed at the fetch recipe's
    shapes (added to `checks`, `fused_plans`, `times` and `bounds`); and
    PPO at the fetch recipe for PPO_FETCH_STEPS training steps and one
    evaluation, with exact launch counts."""
    device = DEVICE
    phase("v1 fetch, hopper, walker2d: pbd_step parity")
    gen = torch.Generator(device=device).manual_seed(7)
    b_scene = {}
    for name, env_ in b_envs.items():
        if name == "fetch":
            states = fetch_states(env_.unwrapped, N_ENVS, 0, device)
        else:
            states = force_scene_states(name, env_, N_ENVS, 0, device)
        checks_b = {}
        for state, (qp, act) in states.items():
            share = contact_share(env_.sys, qp, act)
            legs = ""
            if name == "fetch":
                down = corners_down(env_.unwrapped, qp)
                legs = (f", box corners below the ground per lower leg: "
                        f"{torch.bincount(down.flatten(), minlength=9).tolist()} (0-8)")
            print(f"parity state: {name}, {N_ENVS} envs, {state}, action {tuple(act.shape)}, "
                  f"{share:.3f} in contact{legs}; one pass by {RULES[name][state][0]}, the "
                  f"whole step by {RULES[name][state][1]}")
            checks_b[state] = {**hold_capcap(name, state, env_.sys, qp, act, gen,
                                             f"{name} {state} "), "contact_share": share}
        b_scene[name] = {"sys": env_.sys, "qp": qp, "act": act, "checks": checks_b}

    phase("v1 fetch, hopper, walker2d: main paths")
    b_main = {}
    for name, steps in FETCH_ENV_STEPS.items():
        env_, state_, act_gen, b_main[name] = v1_main_path(
            tag, name, steps, FETCH_OBS[name], warm=20 if steps == MAIN_STEPS else 10)
        if name == "fetch":
            state_, b_main[name]["profile"] = profile_env_step(tag, name, env_, state_, act_gen)

    phase("v1 fetch, hopper, walker2d: pbd_step timings")
    for name, r in b_scene.items():
        sys_, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(sys_, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=5, warmup=1)
        r["ms_by_envs"] = pbd_timings(tag, sys_, qp, act, b[0] / N_ENVS, name)
        print(f"bound {tag}: pbd_step {name} at {N_ENVS} envs: {b[3]} bytes -> {b[4]:.5f} ms at "
              f"3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> {b[5]:.5f} ms at 67 "
              f"TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("v1 fetch: fused_mlp parity and timings")
    for name, rows in FETCH_PARITY_SHAPES:
        for mode in ("bf16", "f32"):
            checks[name, rows, mode] = check_chain(name, rows, mode == "bf16")
            for kind, r in checks[name, rows, mode].items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{r['max_abs_err']:.3e}, mean|err|/mean|plain| up to "
                      f"{r['max_mean_rel_err']:.3e}, {r['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")
        for kind in ("fwd", "bwd"):
            fused_plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(CHAINS[name]), rows, device, kind == "bwd").items() if k != "scratch"}
    for name, rows in FETCH_TIMING_SHAPES:
        times[name, rows, "bf16"] = t = time_chain(name, rows, True)
        for kind in ("fwd", "bwd"):
            bounds[kind, name, rows, "bf16"] = b = chain_bound(CHAINS[name], rows, True,
                                                               kind == "bwd")
            print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} bf16: kernel {t[kind]:.4f} ms "
                  f"graph-replayed ({t[kind + '_host']:.4f} host-issued), plain "
                  f"{t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                  f"{t['cublas_' + kind]:.4f} ms graph-replayed; bound {b[0]:.5f} ms by {b[1]}")

    phase("v1 fetch: PPO")
    p_f = recipe("fetch")
    rollout_f, sgd_f, _ = launch_plan(p_f)
    per_step_f = {"pbd_step": rollout_f * p_f["action_repeat"],
                  "fused_mlp_fwd": rollout_f + 3 * sgd_f, "fused_mlp_bwd": 2 * sgd_f}
    if per_step_f != {"pbd_step": 80, "fused_mlp_fwd": 464, "fused_mlp_bwd": 256}:
        raise AssertionError(f"fetch recipe launches per training step {per_step_f}")
    if env_steps_per_training_step(p_f) != 163_840:
        raise AssertionError(f"fetch recipe env steps per training step "
                             f"{env_steps_per_training_step(p_f)}")
    want_f = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_f, PPO_FETCH_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), f_ppo = run_ppo(True, PPO_FETCH_STEPS, environment="fetch",
                                           preset="fetch", network_factory=recorder.factory)
    torch.cuda.synchronize()
    f_ppo_s = time.perf_counter() - t0
    f_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO fetch", f_ppo, recorder, policy_params, f_launches, want_f)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (FETCH_OBS["fetch"], 20):
        raise AssertionError(f"the fetch policy maps {widths[0]} inputs to {widths[1]}")
    f_fused_ms = {
        "fwd": rollout_f * times["policy_fetch", 2048, "bf16"]["fwd"] + sgd_f * sum(
            times[c + "_fetch", r, "bf16"]["fwd"]
            for c, r in (("policy", 5120), ("value", 5120), ("value", 256))),
        "bwd": sgd_f * sum(times[c + "_fetch", 5120, "bf16"]["bwd"] for c in ("policy", "value")),
    }
    print(f"main path PPO fetch: {PPO_FETCH_STEPS} training steps at the fetch recipe (num_envs "
          f"{p_f['num_envs']}, batch {p_f['batch_size']} x {p_f['num_minibatches']} minibatches, "
          f"unroll {p_f['unroll_length']}, {p_f['num_updates_per_batch']} updates) + one eval "
          f"of {PPO_EVAL_ENVS} envs in {f_ppo_s:.1f} s; launches {f_launches} (as expected; per "
          f"training step {per_step_f}); total_loss {f_ppo['training/total_loss']:.5g}, "
          f"eval/episode_reward {f_ppo['eval/episode_reward']:.5g}; every parameter moved "
          f"(smallest max change {moved:.3e})")
    print(f"timing {tag}: PPO fetch training env-steps/s over step 2 (host clock, fused_mlp on): "
          f"{f_ppo['training/sps_after_first']:.1f}; fused device ms per training step "
          f"(graph-replayed times x launches): fwd {f_fused_ms['fwd']:.3f}, bwd "
          f"{f_fused_ms['bwd']:.3f}")
    return {"scene": b_scene, "main": b_main, "launches": f_launches, "ppo": f_ppo,
            "per_step": per_step_f, "fused_ms": f_fused_ms, "seconds": f_ppo_s}


def spring_ant(batch_size, device):
    """The bare spring ant (envs.create_fn("ant", legacy_spring=True)): the
    factory PPO trains on."""
    return SPRING_ANT(batch_size=batch_size, device=device).unwrapped


def spring_physics_path(tag, name, steps):
    """inverted_double_pendulum's legacy-spring System, whose env cannot
    reset (its reset raises, checked here, as the JAX env's does): `steps`
    sys.step calls at N_ENVS envs from default_qp (both angles 0) with
    random actions, exactly one PBD launch each, finite states."""
    env = spring_env(name, N_ENVS, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    try:
        env.reset(gen)
    except RuntimeError as err:
        print(f"main path {name} (legacy spring): reset raises, as the JAX env's does: {err}")
    else:
        raise AssertionError(f"{name}'s legacy-spring env reset")
    zero = torch.zeros((N_ENVS, 0), device=DEVICE)
    qp = env.default_qp(joint_angle=zero, joint_velocity=zero)
    kernels.pbd_step_launch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        act = torch.rand((N_ENVS, env.action_size), generator=gen, device=DEVICE) * 2 - 1
        qp, _ = env.sys.step(qp, act)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = kernels.pbd_step_launch.launches
    if launches != steps:
        raise AssertionError(f"{steps} {name} spring steps made {launches} kernel launches")
    if not all(bool(torch.isfinite(t).all()) for t in (qp.pos, qp.rot, qp.vel, qp.ang)):
        raise AssertionError(f"non-finite {name} spring state after the main path")
    print(f"main path {name} (legacy spring): {steps} sys.step calls from default_qp, "
          f"{launches} kernel launches, state finite; {step_s * 1e3:.4f} ms/step (host clock) "
          f"{tag}")
    return {"launches": launches, "sys_step_ms": step_s * 1e3}


def spring_paths(tag, phase, s_envs):
    """The legacy-spring phases (the PBD kernel's PBD_SPRING section) of the
    eight envs legacy_spring=True switches (`s_envs`, the bare envs at
    N_ENVS): each spring System against the twin from a reset and after 10
    twin steps (pbd_parity.spring_states), over one substep and over the
    whole step, each by the rule pbd_parity.RULES names; the main paths
    (env.step of spring ant, profiled, and six more; the double pendulum's
    System from default_qp), exact launch counts; the kernel's timings and
    bound per scene; PPO at the ant recipe on the spring ant for
    PPO_SPRING_STEPS training steps and one evaluation, with exact launch
    counts."""
    device = DEVICE
    phase("legacy spring: pbd_step parity")
    gen = torch.Generator(device=device).manual_seed(7)
    s_scene = {}
    for name, env_ in s_envs.items():
        checks_s = {}
        for state, (qp, act) in spring_states(name, env_, N_ENVS, 0, device).items():
            share = contact_share(env_.sys, qp, act)
            rule = RULES[f"{name}_spring"][state]
            print(f"parity state: {name} (legacy spring), {N_ENVS} envs, {state}, action "
                  f"{tuple(act.shape)}, {share:.3f} in contact; one substep by {rule[0]}, the "
                  f"whole step by {rule[1]}")
            checks_s[state] = {**hold_capcap(f"{name}_spring", state, env_.sys, qp, act, gen,
                                             f"{name} spring {state} "),
                               "contact_share": share}
        s_scene[name] = {"sys": env_.sys, "qp": qp, "act": act, "checks": checks_s}

    phase("legacy spring: main paths")
    s_main = {}
    for name, steps in SPRING_ENV_STEPS.items():
        if name == "inverted_double_pendulum":
            s_main[name] = spring_physics_path(tag, name, steps)
            continue
        env_, state_, act_gen, s_main[name] = v1_main_path(
            tag, name, steps, SPRING_OBS[name], warm=20 if steps == MAIN_STEPS else 10,
            label=f"{name} (legacy spring)", legacy_spring=True)
        if name == "ant":
            state_, s_main[name]["profile"] = profile_env_step(tag, "ant (legacy spring)", env_,
                                                               state_, act_gen)

    phase("legacy spring: pbd_step timings")
    for name, r in s_scene.items():
        sys_, qp, act = r["sys"], r["qp"], r["act"]
        b = pbd_bound(sys_, qp, act)
        r["bound"] = dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4]))
        r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=5, warmup=1)
        r["ms_by_envs"] = pbd_timings(tag, sys_, qp, act, b[0] / N_ENVS, f"{name} spring")
        print(f"bound {tag}: pbd_step {name} spring at {N_ENVS} envs: {b[3]} bytes -> "
              f"{b[4]:.5f} ms at 3.35 TB/s; {b[2]} fp32 ops (the twin's, counted) -> "
              f"{b[5]:.5f} ms at 67 TFLOP/s; plain twin {r['plain_ms']:.3f} ms/step")

    phase("legacy spring: PPO on the spring ant")
    p_s = recipe("ant")
    rollout_s, sgd_s, _ = launch_plan(p_s)
    per_step_s = {"pbd_step": rollout_s * p_s["action_repeat"],
                  "fused_mlp_fwd": rollout_s + 3 * sgd_s, "fused_mlp_bwd": 2 * sgd_s}
    if per_step_s != {"pbd_step": 80, "fused_mlp_fwd": 464, "fused_mlp_bwd": 256}:
        raise AssertionError(f"ant recipe launches per training step {per_step_s}")
    want_s = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      expected_launches(p_s, PPO_SPRING_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), s_ppo = run_ppo(True, PPO_SPRING_STEPS, environment=spring_ant,
                                           preset="ant", network_factory=recorder.factory)
    torch.cuda.synchronize()
    s_ppo_s = time.perf_counter() - t0
    s_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                  "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                  "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO spring ant", s_ppo, recorder, policy_params, s_launches, want_s)
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (87, 16):
        raise AssertionError(f"the spring ant policy maps {widths[0]} inputs to {widths[1]}")
    print(f"main path PPO spring ant: {PPO_SPRING_STEPS} training steps at the ant recipe "
          f"(num_envs {p_s['num_envs']}, batch {p_s['batch_size']} x "
          f"{p_s['num_minibatches']} minibatches, unroll {p_s['unroll_length']}, "
          f"{p_s['num_updates_per_batch']} updates) on envs.create_fn(\"ant\", "
          f"legacy_spring=True) + one eval of {PPO_EVAL_ENVS} envs in {s_ppo_s:.1f} s; "
          f"launches {s_launches} (as expected; per training step {per_step_s}); total_loss "
          f"{s_ppo['training/total_loss']:.5g}, eval/episode_reward "
          f"{s_ppo['eval/episode_reward']:.5g}; every parameter moved (smallest max change "
          f"{moved:.3e})")
    print(f"timing {tag}: PPO spring ant training env-steps/s over step 2 (host clock, fused_mlp "
          f"on): {s_ppo['training/sps_after_first']:.1f}")
    return {"scene": s_scene, "main": s_main, "launches": s_launches, "ppo": s_ppo,
            "per_step": per_step_s, "seconds": s_ppo_s}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    start = time.perf_counter()
    phase = lambda label: print(f"[{time.perf_counter() - start:.1f} s] {label}", flush=True)
    name_limit = cuda_build.card()
    print(name_limit)
    tag = f"[{name_limit}]"

    # -- build: every source, one nvcc each, in parallel ---------------------------
    t0 = time.perf_counter()
    env = envs.create("ant", episode_length=1000, auto_reset=True, batch_size=N_ENVS)
    sys_ = env.sys
    gen_env = v2_envs.create("ant", episode_length=1000, batch_size=N_ENVS)
    gen_sys = gen_env.sys
    scenes = [gen_sys] + [v2_envs.get_environment(name).sys for name in V2_ENVS]
    h_envs = {name: envs.create(name, episode_length=1000, batch_size=N_ENVS)
              for name in HUMANOID_SCENES}
    c_envs = {name: envs.create(name, episode_length=1000, batch_size=N_ENVS)
              for name in CAPCAP_SCENES}
    f_envs = {name: envs.create(name, episode_length=1000, batch_size=N_ENVS)
              for name in FORCE_SCENES}
    g_envs = {name: envs.create(name, episode_length=1000, batch_size=N_ENVS)
              for name in GRASP_ENV_STEPS}
    b_envs = {name: envs.create(name, episode_length=1000, batch_size=N_ENVS)
              for name in FETCH_ENV_STEPS}
    s_envs = {name: spring_env(name, N_ENVS, device) for name in SPRING_SCENES}
    built = cuda_build.build(kernels.kernel_source(sys_), fused_mlp.SOURCE, probe.SOURCE,
                             *(kernels.kernel_source(e.sys) for e in h_envs.values()),
                             *(kernels.kernel_source(e.sys) for e in c_envs.values()),
                             *(kernels.kernel_source(one_pass(e.sys)) for e in c_envs.values()),
                             *(kernels.kernel_source(e.sys) for e in f_envs.values()),
                             *(kernels.kernel_source(e.sys) for e in g_envs.values()),
                             kernels.kernel_source(one_pass(g_envs["grasp"].sys)),
                             *(kernels.kernel_source(e.sys) for e in b_envs.values()),
                             *(kernels.kernel_source(one_pass(e.sys)) for e in b_envs.values()),
                             *(kernels.kernel_source(e.sys) for e in s_envs.values()),
                             *(kernels.kernel_source(one_pass(e.sys)) for e in s_envs.values()),
                             kernels.kernel_source(twister_swimmer(device)),
                             *(gen_kernels.kernel_source(s) for s in scenes))
    print(f"build: {', '.join(p.name for p in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    print(kernels.ptxas_report(sys_).strip())
    for e in (*h_envs.values(), *c_envs.values(), *f_envs.values(), *g_envs.values(),
              *b_envs.values()):
        print(kernels.ptxas_report(e.sys).strip())
    for name, e in s_envs.items():
        for label, s_ in (("", e.sys), (" one substep", one_pass(e.sys))):
            print(f"{name} (legacy spring){label}: " + " ".join(
                line.strip() for line in kernels.ptxas_report(s_).splitlines()
                if "registers" in line or "spill" in line))
    print(fused_mlp.ptxas_report().strip())
    print(probe.ptxas_report().strip())
    for scene in scenes:
        print(gen_kernels.ptxas_report(scene).strip())
    pbd_launch = pbd_launch_report(sys_, PBD_TIMING_ENVS)
    h_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, name)
                for name, e in h_envs.items()}
    c_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, CAPCAP_LABEL[name])
                for name, e in c_envs.items()}
    f_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, name)
                for name, e in f_envs.items()}
    g_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, name)
                for name, e in g_envs.items()}
    b_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, name)
                for name, e in b_envs.items()}
    s_launch = {name: pbd_launch_report(e.sys, PBD_TIMING_ENVS, f"{name} (legacy spring)")
                for name, e in s_envs.items()}
    hgmma = cuda_build.sass_count(built[probe.SOURCE], "HGMMA")
    print(f"probe dot_chain build: {hgmma} HGMMA (wgmma) instructions in "
          f"{built[probe.SOURCE].name} (cuobjdump --dump-sass)")
    if not hgmma:
        raise AssertionError("the dot chain's build holds no HGMMA instruction")
    gen_batches = (N_ENVS, recipe()["num_envs"])
    gen_launches_by_scene = {name: gen_launch_report(name, scene, gen_batches)
                             for name, scene in zip(("ant",) + V2_ENVS, scenes)}

    # the probe runs on no env or PPO path: its counts, set to 0 here, are
    # read before its own phase
    probe.copy_plus_one.launches = probe.dot_chain.launches = 0

    # -- kernel against its plain twin at 4096 envs, in contact ---------------
    phase("pbd_step parity")
    gen = torch.Generator(device=device).manual_seed(0)
    qp = env.reset(gen).qp
    for _ in range(10):
        act = torch.rand((N_ENVS, env.action_size), generator=gen, device=device) * 2 - 1
        qp, info = kernels.pbd_step_plain(sys_, qp, act)
    in_contact = float((info.contact.vel.abs().amax(dim=(1, 2)) > 0).float().mean())
    print(f"parity state: {N_ENVS} envs after 10 twin steps, {in_contact:.3f} in contact")
    act = torch.rand((N_ENVS, env.action_size), generator=gen, device=device) * 2 - 1
    errs, inside_errs, outliers = max_errors(sys_, qp, act, gen)

    # -- main path: 200 env steps through envs.create ---------------------------
    phase("main path: env.step")
    env, state, act_gen, ant_main = v1_main_path(tag, "ant", MAIN_STEPS, 87, warm=20)
    launches, step_s = ant_main["launches"], ant_main["env_step_ms"] / 1e3

    # -- timings ------------------------------------------------------------
    phase("pbd_step timings")
    plain_ms = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=10, warmup=2)
    bound_ms, bound_by, ops, n_bytes, bytes_ms, ops_ms = pbd_bound(sys_, qp, act)
    # the twin's operations and the bytes scale with the envs: the bound per env
    pbd_by_envs = pbd_timings(tag, sys_, qp, act, bound_ms / N_ENVS)
    kernel_ms = pbd_by_envs[N_ENVS]["graph"]
    print(f"timing {tag}: plain twin {plain_ms:.3f} ms/step at {N_ENVS} envs")
    print(f"timing {tag}: env.step {step_s * 1e3:.4f} ms/step, "
          f"{N_ENVS / step_s:.1f} env-steps/s (host clock, {MAIN_STEPS - 20} steps)")
    print(f"bound {tag}: {n_bytes} bytes -> {bytes_ms:.5f} ms at 3.35 TB/s; "
          f"{ops} fp32 ops (the twin's, counted) -> {ops_ms:.5f} ms at 67 TFLOP/s")

    # -- where env.step's device time goes ---------------------------------------
    state, ant_profile = profile_env_step(tag, "ant", env, state, act_gen)

    # -- fused MLP kernels against their plain versions, recipe shapes ------------
    phase("fused_mlp parity")
    checks = {}
    for name, rows in CHAIN_SHAPES:
        for mode in ("bf16", "f32"):
            checks[name, rows, mode] = check_chain(name, rows, mode == "bf16")
            for kind, r in checks[name, rows, mode].items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{r['max_abs_err']:.3e}, mean|err|/mean|plain| up to "
                      f"{r['max_mean_rel_err']:.3e}, {r['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")

    fused_plans = {}
    for name, rows in CHAIN_SHAPES:
        for kind in ("fwd", "bwd"):
            fused_plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(CHAINS[name]), rows, device, kind == "bwd").items() if k != "scratch"}
            print(f"launch fused_mlp_{kind} {name}@{rows} bf16: {fused_plans[kind, name, rows]}")

    # -- main path 2: PPO on ant, the published recipe at full width ---------------
    phase("main path: PPO")
    p = recipe()
    want = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                    expected_launches(p, PPO_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), ppo_metrics = run_ppo(True, PPO_STEPS,
                                                 network_factory=recorder.factory)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t0
    ppo_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                    "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                    "pbd_step": kernels.pbd_step_launch.launches}
    moved = check_ppo_run("PPO", ppo_metrics, recorder, policy_params, ppo_launches, want)
    print(f"main path PPO: {PPO_STEPS} training steps of ant "
          f"(num_envs {p['num_envs']}, batch {p['batch_size']} x {p['num_minibatches']} "
          f"minibatches, unroll {p['unroll_length']}, {p['num_updates_per_batch']} updates) + "
          f"one eval of {PPO_EVAL_ENVS} envs in {ppo_s:.1f} s; launches {ppo_launches} "
          f"(as expected); total_loss {ppo_metrics['training/total_loss']:.5g}, "
          f"eval/episode_reward {ppo_metrics['eval/episode_reward']:.5g}; every parameter "
          f"moved (smallest max change {moved:.3e})")

    # -- fused kernel timings ------------------------------------------------------
    phase("fused_mlp timings")
    times, bounds = {}, {}
    for name, rows in CHAIN_SHAPES:
        for mode in ("bf16", "f32"):
            times[name, rows, mode] = t = time_chain(name, rows, mode == "bf16")
            for kind in ("fwd", "bwd"):
                bounds[kind, name, rows, mode] = b = chain_bound(
                    CHAINS[name], rows, mode == "bf16", kind == "bwd")
                print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} {mode}: kernel "
                      f"{t[kind]:.4f} ms graph-replayed ({t[kind + '_host']:.4f} host-issued), "
                      f"plain {t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                      f"{t['cublas_' + kind]:.4f} ms graph-replayed "
                      f"({t['cublas_' + kind + '_host']:.4f} host-issued); bound {b[0]:.5f} ms by "
                      f"{b[1]} ({b[2]:.4g} ops, {b[3]} bytes)")
    # device ms per training step in each kernel, bf16 (the main path's mode),
    # from the graph-replayed times
    n_rollout, n_sgd, _ = launch_plan(p)
    def per_training_step(v):
        return {
            "fwd": n_rollout * times["policy" + v, 2048, "bf16"]["fwd"] + n_sgd * sum(
                times[c + v, r, "bf16"]["fwd"] for c, r in (("policy", 5120), ("value", 5120),
                                                           ("value", 1024))),
            "bwd": n_sgd * sum(times[c + v, 5120, "bf16"]["bwd"] for c in ("policy", "value")),
        }

    per_step, per_step_v2 = per_training_step(""), per_training_step("_v2")
    per_step_launches = {"fwd": n_rollout + 3 * n_sgd, "bwd": 2 * n_sgd}
    for label, ms in (("v1 ant", per_step), ("v2 ant", per_step_v2)):
        print(f"timing {tag}: per training step of PPO on {label}, fused_mlp_fwd "
              f"{ms['fwd']:.3f} ms ({per_step_launches['fwd']} launches), fused_mlp_bwd "
              f"{ms['bwd']:.3f} ms ({per_step_launches['bwd']} launches)")

    # -- PPO env-steps/s, fused kernels on and off, in turns ---------------------
    phase("PPO timings and profiles")
    sps = {"on": [ppo_metrics["training/sps_after_first"]], "off": []}
    for fused in (False, True, False):
        sps["on" if fused else "off"].append(
            run_ppo(fused, PPO_STEPS)[2]["training/sps_after_first"])
    print(f"timing {tag}: PPO training env-steps/s over steps 2-{PPO_STEPS} (host clock): "
          f"fused_mlp on {sps['on']}, off {sps['off']}")
    profiles = {mode: print_profile(tag, "", mode, profile_training_step(fused))
                for mode, fused in (("on", True), ("off", False))}

    h = humanoid_paths(tag, phase, h_envs, checks, fused_plans, times, bounds)
    h_scene, h_main, h_launches, h_ppo = h["scene"], h["main"], h["launches"], h["ppo"]
    per_step_h, h_fused_ms, h_ppo_s = h["per_step"], h["fused_ms"], h["seconds"]
    c = capcap_paths(tag, phase, c_envs, checks, fused_plans, times, bounds)
    c_scene, c_main, c_launches = c["scene"], c["main"], c["launches"]
    f = force_paths(tag, phase, f_envs)
    f_scene, f_main, f_launches = f["scene"], f["main"], f["launches"]
    g = grasp_paths(tag, phase, g_envs, checks, fused_plans, times, bounds)
    g_scene, g_main, g_launches = g["scene"], g["main"], g["launches"]
    fe = fetch_paths(tag, phase, b_envs, checks, fused_plans, times, bounds)
    b_scene, b_main, b_launches = fe["scene"], fe["main"], fe["launches"]
    sp_ = spring_paths(tag, phase, s_envs)
    s_scene, s_main, s_launches = sp_["scene"], sp_["main"], sp_["launches"]

    def fused_entry(kind, replaces, function):
        main = ("value", 5120, "bf16")
        b = bounds[(kind,) + main]
        return {
            "name": f"fused_mlp_{kind}",
            "route": "cuda",
            "source": "brax_torch/csrc/fused_mlp.cu",
            "replaces": replaces,
            "replaces_function": function,
            "launches": ppo_launches[f"fused_mlp_{kind}"],
            "launches_by_path": {"PPO ant": ppo_launches[f"fused_mlp_{kind}"],
                                 "PPO v2 ant": v2_launches[f"fused_mlp_{kind}"],
                                 "PPO humanoid": h_launches[f"fused_mlp_{kind}"],
                                 "PPO v1 halfcheetah": c_launches[f"fused_mlp_{kind}"],
                                 "PPO grasp": g_launches[f"fused_mlp_{kind}"],
                                 "PPO fetch": b_launches[f"fused_mlp_{kind}"],
                                 "PPO spring ant": s_launches[f"fused_mlp_{kind}"],
                                 "probe": probe_launches.get(f"fused_mlp_{kind}", 0)},
            "launches_per_training_step": per_step_launches[kind],
            "max_abs_err": max(c[kind]["max_abs_err"] for k, c in checks.items()
                               if k[2] == "bf16"),
            "max_abs_err_f32": max(c[kind]["max_abs_err"] for k, c in checks.items()
                                   if k[2] == "f32"),
            "tolerance": {"bf16_rel_to_max": BF16_REL, "f32_rtol_atol": F32_TOL[kind]},
            "shape": "value chain 87-256x5-1 at 5120 rows, bf16; by_shape has every "
                     "chain of the PPO paths (87-wide v1 ant, 27-wide v2 ant, 240-wide "
                     "humanoid, 18-wide v1 halfcheetah, 132-wide grasp, 101-wide fetch)",
            "ms": times[main][kind],
            "ms_host_issued": times[main][kind + "_host"],
            "ms_clock": f"replayed from a CUDA graph of {GRAPH_CALLS} calls; ms_host_issued: "
                        "CUDA events over 200 back-to-back wrapper calls",
            "plain_ms": times[main]["plain_" + kind],
            "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": None,
            "cublas_chain_ms": times[main]["cublas_" + kind],
            "cublas_chain_ms_host_issued": times[main]["cublas_" + kind + "_host"],
            "ms_per_training_step": per_step[kind],
            "ms_per_training_step_v2": per_step_v2[kind],
            "ms_per_training_step_humanoid": h_fused_ms[kind],
            "ms_per_training_step_halfcheetah": c["fused_ms"][kind],
            "ms_per_training_step_grasp": g["fused_ms"][kind],
            "ms_per_training_step_fetch": fe["fused_ms"][kind],
            "launch": fused_plans[kind, "value", 5120],
            "by_shape": [
                {"chain": c, "rows": r, "mode": m, "ms": times[c, r, m][kind],
                 "ms_host_issued": times[c, r, m][kind + "_host"],
                 "plain_ms": times[c, r, m]["plain_" + kind],
                 "cublas_chain_ms": times[c, r, m]["cublas_" + kind],
                 "cublas_chain_ms_host_issued": times[c, r, m]["cublas_" + kind + "_host"],
                 "bound_ms": bounds[kind, c, r, m][0], "bound_by": bounds[kind, c, r, m][1],
                 **({"launch": fused_plans[kind, c, r]} if m == "bf16" else {}),
                 **checks[c, r, m][kind]}
                for (c, r, m) in times
            ],
            "card": name_limit,
        }

    # -- generalized step against its plain version, 4096 envs, in contact ---------
    phase("gen_step parity")
    gen = torch.Generator(device=device).manual_seed(0)
    ps = gen_env.reset(gen).pipeline_state
    q, qd, minv = ps.q, ps.qd, ps.mass_mx_inv
    for _ in range(10):
        act = torch.rand((N_ENVS, 8), generator=gen, device=device) * 2 - 1
        out = gen_kernels.gen_step_plain(gen_sys, q, qd, minv, act, GEN_FRAMES)
        q, qd, minv = out["q"], out["qd"], out["minv"]
    gen_contact = float((out["c_pen"] > 0).any(dim=1).float().mean())
    print(f"gen_step parity state: {N_ENVS} envs after 10 plain env steps, {gen_contact:.3f} "
          f"with a foot in contact")
    gen_ins = (q, qd, minv, torch.rand((N_ENVS, 8), generator=gen, device=device) * 2 - 1)
    gen_checks = {f"{nf} frame(s)": gen_max_errors(gen_sys, gen_ins, nf, gen, f"{nf} frame(s)")
                  for nf in (1, GEN_FRAMES)}
    # a contact-rich start as well: reset noise with the torso lowered by up
    # to 0.35, so that most envs start with a foot on the floor
    q_noise = torch.rand((N_ENVS, 15), generator=gen, device=device) * 0.2 - 0.1
    q_noise[:, 2] -= torch.rand(N_ENVS, generator=gen, device=device) * 0.35
    ps = gen_env.unwrapped.reset_from_noise(
        q_noise, 0.1 * torch.randn((N_ENVS, 14), generator=gen, device=device)).pipeline_state
    low_contact = float((ps.contact.penetration > 0).any(dim=1).float().mean())
    print(f"gen_step parity state: {N_ENVS} envs from reset, torso lowered, {low_contact:.3f} "
          f"with a foot in contact")
    low_ins = (ps.q, ps.qd, ps.mass_mx_inv, gen_ins[3])
    label = f"{GEN_FRAMES} frame(s), lowered"
    gen_checks[label] = gen_max_errors(gen_sys, low_ins, GEN_FRAMES, gen, label)

    # -- main path 3: the v2 generalized ant, 200 env steps ---------------------------
    phase("main path: v2 env.step")
    state = gen_env.reset(torch.Generator(device=device).manual_seed(1))
    act_gen = torch.Generator(device=device).manual_seed(2)
    gen_kernels.gen_step_soa.launches = 0
    for i in range(MAIN_STEPS):
        if i == 20:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        act = torch.rand((N_ENVS, 8), generator=act_gen, device=device) * 2 - 1
        state = gen_env.step(state, act)
    torch.cuda.synchronize()
    gen_step_s = (time.perf_counter() - t0) / (MAIN_STEPS - 20)
    gen_launches = gen_kernels.gen_step_soa.launches
    if gen_launches != MAIN_STEPS:
        raise AssertionError(f"{MAIN_STEPS} v2 env steps made {gen_launches} gen_step launches")
    if state.obs.shape != (N_ENVS, 27) or not bool(torch.isfinite(state.obs).all()):
        raise AssertionError(f"v2 obs {tuple(state.obs.shape)}, finite "
                             f"{bool(torch.isfinite(state.obs).all())}")
    print(f"main path v2: {MAIN_STEPS} env.step calls, {gen_launches} gen_step launches, obs "
          f"(4096, 27) finite, done fraction {float(state.done.mean()):.4f}")

    # -- gen_step timings, bound and profile ----------------------------------------------
    phase("gen_step timings")
    soa = lambda x: x.reshape(N_ENVS, -1).t().contiguous()
    gen_soa = tuple(soa(x) for x in gen_ins)
    gen_ms = cuda_ms(lambda: gen_kernels.gen_step_soa(gen_sys, *gen_soa, GEN_FRAMES), 100, 10)
    gen_plain_ms = cuda_ms(lambda: gen_kernels.gen_step_plain(gen_sys, *gen_ins, GEN_FRAMES), 3, 1)
    gen_bound_ms, gen_bound_by, gen_ops, gen_bytes = gen_bound(gen_sys, gen_ins, GEN_FRAMES)
    ref_ms = GEN_REFERENCE_FLOPS * N_ENVS / FP32_OPS_PER_S * 1e3
    print(f"timing {tag}: gen_step kernel {gen_ms:.4f} ms/launch ({GEN_FRAMES} frames, "
          f"{N_ENVS} envs, CUDA events, 100 launches)")
    print(f"timing {tag}: gen_step plain version {gen_plain_ms:.3f} ms/step")
    print(f"timing {tag}: v2 env.step {gen_step_s * 1e3:.4f} ms/step, "
          f"{N_ENVS / gen_step_s:.1f} env-steps/s (host clock, {MAIN_STEPS - 20} steps)")
    print(f"bound {tag}: gen_step {gen_bytes} bytes -> "
          f"{gen_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms at 3.35 TB/s; {gen_ops} fp32 ops (the "
          f"plain version's, counted) -> {gen_ops / FP32_OPS_PER_S * 1e3:.5f} ms at 67 TFLOP/s; "
          f"the reference's static count, {GEN_REFERENCE_FLOPS} flops per env step "
          f"(bench.py:291), would be {ref_ms:.5f} ms")
    state, gen_profile = profile_env_step(tag, "v2 ant", gen_env, state, act_gen)

    # -- gen_step envs per block: one pass -----------------------------------------
    phase("gen_step envs per block")
    sweep = {}
    for n_sweep in GEN_SWEEP_ENVS:
        sweep_ins = tuple(x.repeat(1, n_sweep // N_ENVS).contiguous() for x in gen_soa)
        sweep[n_sweep] = {e: cuda_ms(lambda: gen_kernels.gen_step_soa(
            gen_sys, *sweep_ins, GEN_FRAMES, block=e), 30, 3)
            for e in range(1, gen_launches_by_scene["ant"]["max_envs_per_block"] + 1)}
        default = gen_kernels.launch_envs_per_block(gen_sys, sweep_ins[0].device, n_sweep)
        best = min(sweep[n_sweep], key=sweep[n_sweep].get)
        print(f"timing {tag}: gen_step at {n_sweep} envs by envs (warps) per block (ms per "
              f"launch): {sweep[n_sweep]}; default {default} ({sweep[n_sweep][default]:.4f} ms), "
              f"fastest {best} ({sweep[n_sweep][best]:.4f} ms)")

    # -- the other v2 envs: parity at 4096 envs, then each main path ------------------
    phase("v2 envs: gen_step parity")
    v2_checks, v2_contact = {}, {}
    for name in V2_ENVS:
        env = v2_envs.create(name, episode_length=1000, batch_size=N_ENVS)
        v2_checks[name], v2_contact[name] = v2_parity(
            name, env, torch.Generator(device=device).manual_seed(0))
    phase("main paths: v2 envs")
    v2_records = {name: v2_main_path(name, tag) for name in V2_ENVS}

    # -- main path: PPO on the v2 ant, the ant recipe ----------------------------------
    phase("main path: PPO on v2 ant")
    want_v2 = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "gen_step"),
                       expected_launches(p, PPO_STEPS)))
    recorder = InitRecorder()
    gen_kernels.gen_step_soa.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), v2_metrics = run_ppo(True, PPO_STEPS, environment=v2_ant,
                                                network_factory=recorder.factory)
    torch.cuda.synchronize()
    v2_ppo_s = time.perf_counter() - t0
    v2_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                   "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                   "gen_step": gen_kernels.gen_step_soa.launches}
    moved = check_ppo_run("PPO v2", v2_metrics, recorder, policy_params, v2_launches, want_v2)
    obs_width = recorder.initial["policy"]["hidden_0.kernel"].shape[0]
    if obs_width != 27:
        raise AssertionError(f"the v2 ant policy takes {obs_width} inputs, not 27")
    print(f"main path PPO v2: {PPO_STEPS} training steps of the v2 ant at the ant recipe + one "
          f"eval of {PPO_EVAL_ENVS} envs in {v2_ppo_s:.1f} s; launches {v2_launches} (as "
          f"expected); obs width {obs_width}; total_loss "
          f"{v2_metrics['training/total_loss']:.5g}, eval/episode_reward "
          f"{v2_metrics['eval/episode_reward']:.5g}; every parameter moved (smallest max change "
          f"{moved:.3e})")
    phase("PPO v2 timings")
    # the kernel at the recipe's batch, on the ant parity inputs' first envs
    v2_kernel_ms = cuda_ms(lambda: gen_kernels.gen_step_soa(
        gen_sys, *(x[:, :p["num_envs"]].contiguous() for x in gen_soa), GEN_FRAMES), 50, 5)
    print(f"timing {tag}: gen_step {v2_kernel_ms:.4f} ms/launch at the recipe's {p['num_envs']} "
          f"envs; {want_v2['gen_step']} launches in the PPO v2 run")
    v2_sps = {"on": [v2_metrics["training/sps_after_first"]], "off": []}
    for fused in (False, True, False):
        v2_sps["on" if fused else "off"].append(
            run_ppo(fused, PPO_STEPS, environment=v2_ant)[2]["training/sps_after_first"])
    print(f"timing {tag}: PPO on v2 ant, training env-steps/s over steps 2-{PPO_STEPS} (host "
          f"clock): fused_mlp on {v2_sps['on']}, off {v2_sps['off']}")
    v2_profiles = {mode: print_profile(tag, "PPO v2 ant, ", mode,
                                       profile_training_step(fused, environment=v2_ant))
                   for mode, fused in (("on", True), ("off", False))}

    # -- the launch-overhead probe ------------------------------------------------------
    phase("probe parity")
    probe_on_paths = {"probe_copy_plus_one": probe.copy_plus_one.launches,
                      "probe_dot_chain": probe.dot_chain.launches}
    print(f"probe launches on the env and PPO paths (counts set to 0 before the first): "
          f"{probe_on_paths}")
    chain_errs = {}
    for rows in probe.CHAIN_ROWS:
        gen = torch.Generator(device=device).manual_seed(rows)
        x = torch.randn((rows, probe.WIDTH), generator=gen, device=device)
        w = torch.randn((probe.WIDTH, probe.WIDTH), generator=gen, device=device) * 0.05
        for k in probe.CHAIN_KS:
            got, want_chain = probe.dot_chain(x, w, k), probe.dot_chain_plain(x, w, k)
            err, top = float((got - want_chain).abs().max()), float(want_chain.abs().max())
            print(f"parity probe dot_chain [{rows}, 256] k={k}: max|kernel - plain| = "
                  f"{err:.3e}, {err / (BF16_REL * top):.3f} of the tolerance")
            if err > BF16_REL * top:
                raise AssertionError(f"dot_chain [{rows}, 256] k={k} outside tolerance")
            chain_errs[rows, k] = err
    tile = torch.randn(probe.TILE, device=device)
    copy_errs = {}
    for blocks in (1,) + probe.GRIDS:
        got = probe.copy_plus_one(tile, blocks)
        copy_errs[blocks] = float((got - probe.copy_plus_one_plain(tile)).abs().max())
    print(f"parity probe copy_plus_one: max|kernel - plain| by blocks {copy_errs} (must be 0)")
    if any(copy_errs.values()):
        raise AssertionError(f"copy_plus_one is not x + 1: {copy_errs}")
    phase("main path: probe")
    probe.copy_plus_one.launches = probe.dot_chain.launches = fused_mlp.chain_fwd.launches = 0
    probe.copy_plus_one.replayed = probe.dot_chain.replayed = 0
    probe_times = probe.measure()
    probe_launches = {"probe_copy_plus_one": probe.copy_plus_one.launches,
                      "probe_dot_chain": probe.dot_chain.launches,
                      "fused_mlp_fwd": fused_mlp.chain_fwd.launches}
    probe_replayed = {"probe_copy_plus_one": probe.copy_plus_one.replayed,
                      "probe_dot_chain": probe.dot_chain.replayed}
    if not all(probe_launches.values()):
        raise AssertionError(f"the probe did not launch every kernel: {probe_launches}")
    probe_result = probe.result(probe_times)
    print(f"probe {tag}: launches through the wrappers (host-issued and captured) "
          f"{probe_launches}; replayed from graphs {probe_replayed}; "
          f"RESULT {json.dumps(probe_result)}")
    x_chain, w_chain = probe.inputs(probe.CHAIN_ROWS[-1])
    k_main = probe.CHAIN_KS[-1]
    chain_plain_ms = cuda_ms(lambda: probe.dot_chain_plain(x_chain, w_chain, k_main), 20, 2)
    copy_plain_ms = cuda_ms(lambda: probe.copy_plus_one_plain(tile), 200, 20)
    copy_bytes = 2 * tile.numel() * 4
    probe_bound = {}
    for rows in probe.CHAIN_ROWS:
        for k in probe.CHAIN_KS:
            ops_ms = 2 * rows * probe.WIDTH ** 2 * k / BF16_OPS_PER_S * 1e3
            bytes_ms = 4 * (2 * rows * probe.WIDTH + probe.WIDTH ** 2) / HBM_BYTES_PER_S * 1e3
            probe_bound[rows, k] = (max(ops_ms, bytes_ms),
                                    "bytes" if bytes_ms >= ops_ms else "operations")
    print(f"timing {tag}: probe plain versions: dot_chain [5120, 256] k={k_main} "
          f"{chain_plain_ms:.4f} ms, x + 1 {copy_plain_ms:.4f} ms; bounds: copy "
          f"{copy_bytes / HBM_BYTES_PER_S * 1e3:.2e} ms by bytes, chains {probe_bound}")
    chain_times = {}
    for rows in probe.CHAIN_ROWS:
        for k in probe.CHAIN_KS:
            key = f"dotchain{k}_us" if rows == 512 else f"dotchain{rows}_{k}_us"
            t = chain_times[rows, k] = {
                "graph": probe_times[key]["graph"] / 1e3, "host": probe_times[key]["host"] / 1e3,
                "cublas_graph": probe_times["cublas_" + key]["graph"] / 1e3,
                "bound_ms": probe_bound[rows, k][0]}
            print(f"timing {tag}: dot_chain [{rows}, 256] k={k}: {t['graph']:.5f} ms "
                  f"graph-replayed ({t['host']:.5f} host-issued), cuBLAS chain "
                  f"{t['cublas_graph']:.5f} ms graph-replayed, bound {t['bound_ms']:.5f} ms")

    print(json.dumps({"ppo": {
        "env_steps_per_s_fused_on": sps["on"], "env_steps_per_s_fused_off": sps["off"],
        "eval_episode_reward": ppo_metrics["eval/episode_reward"],
        "profile": {m: {k: v for k, v in prof.items() if k not in ("top", "host_top")}
                    for m, prof in profiles.items()},
        "v2_ant": {"env_steps_per_s_fused_on": v2_sps["on"],
                   "env_steps_per_s_fused_off": v2_sps["off"],
                   "eval_episode_reward": v2_metrics["eval/episode_reward"],
                   "launches": v2_launches, "seconds": v2_ppo_s,
                   "gen_step_ms_at_num_envs": v2_kernel_ms,
                   "profile": {m: {k: v for k, v in prof.items() if k not in ("top", "host_top")}
                               for m, prof in v2_profiles.items()}},
        "humanoid": {"env_steps_per_s_fused_on": h_ppo["training/sps_after_first"],
                     "eval_episode_reward": h_ppo["eval/episode_reward"],
                     "total_loss": h_ppo["training/total_loss"], "launches": h_launches,
                     "launches_per_training_step": per_step_h, "seconds": h_ppo_s,
                     "fused_ms_per_training_step": h_fused_ms},
        "v1 halfcheetah": {"env_steps_per_s_fused_on": c["ppo"]["training/sps_after_first"],
                           "eval_episode_reward": c["ppo"]["eval/episode_reward"],
                           "total_loss": c["ppo"]["training/total_loss"],
                           "launches": c_launches, "launches_per_training_step": c["per_step"],
                           "seconds": c["seconds"], "fused_ms_per_training_step": c["fused_ms"]},
        "reacher": {"env_steps_per_s_fused_on": f["ppo"]["training/sps_after_first"],
                    "eval_episode_reward": f["ppo"]["eval/episode_reward"],
                    "total_loss": f["ppo"]["training/total_loss"], "launches": f_launches,
                    "launches_per_training_step": f["per_step"], "seconds": f["seconds"]},
        "grasp": {"env_steps_per_s_fused_on": g["ppo"]["training/sps_after_first"],
                  "eval_episode_reward": g["ppo"]["eval/episode_reward"],
                  "total_loss": g["ppo"]["training/total_loss"], "launches": g_launches,
                  "launches_per_training_step": g["per_step"], "seconds": g["seconds"],
                  "fused_ms_per_training_step": g["fused_ms"]},
        "fetch": {"env_steps_per_s_fused_on": fe["ppo"]["training/sps_after_first"],
                  "eval_episode_reward": fe["ppo"]["eval/episode_reward"],
                  "total_loss": fe["ppo"]["training/total_loss"], "launches": b_launches,
                  "launches_per_training_step": fe["per_step"], "seconds": fe["seconds"],
                  "fused_ms_per_training_step": fe["fused_ms"]},
        "spring_ant": {"env_steps_per_s_fused_on": sp_["ppo"]["training/sps_after_first"],
                       "eval_episode_reward": sp_["ppo"]["eval/episode_reward"],
                       "total_loss": sp_["ppo"]["training/total_loss"], "launches": s_launches,
                       "launches_per_training_step": sp_["per_step"],
                       "seconds": sp_["seconds"]},
        "card": name_limit}}))
    print(json.dumps({"kernels": [{
        "name": "pbd_step",
        "route": "cuda",
        "source": "brax_torch/csrc/pbd_step.cu",
        "replaces": "brax_tpu/sim/kernels.py:1283",
        "replaces_function": "brax_tpu/sim/kernels.py::_build_tile_step",
        "launches": launches,
        "max_abs_err": max([*errs.values()] + [
            e for r in (*h_scene.values(), *c_scene.values(), *f_scene.values(),
                        *g_scene.values(), *b_scene.values(), *s_scene.values())
            for ck in r["checks"].values()
            if ck.get("rule", "max_errors") == "max_errors"
            for e in ck["max_abs_err_by_field"].values()] + [
            e for r in (*c_scene.values(), g_scene["grasp"], *b_scene.values(),
                        *s_scene.values())
            for ck in r["checks"].values()
            if ck["one_pass"]["rule"] == "max_errors"
            for e in ck["one_pass"]["max_abs_err_by_field"].values()] + [
            *g["twister"]["max_abs_err_by_field"].values()]),
        "max_abs_err_scope": "every env of every check held by max_errors (rounding-decided "
                             "outliers included); the chaotic checks (chaos_rule) under "
                             "by_scene",
        "max_abs_err_by_field": errs,
        "max_abs_err_within_tolerance": max(inside_errs.values()),
        "max_abs_err_within_tolerance_by_field": inside_errs,
        "tolerance": TOLERANCE,
        "outlier_envs_decided_by_rounding": outliers,
        "max_outliers": MAX_OUTLIERS,
        "ms": kernel_ms,
        "ms_host_issued": pbd_by_envs[N_ENVS]["host"],
        "ms_timing": f"graph-replayed ({GRAPH_CALLS} launches per CUDA graph) at {N_ENVS} envs",
        "ms_by_envs": pbd_by_envs,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "design": "per-System source; an env over lanes of a warp, state in registers",
        "launch": pbd_launch,
        "env_steps_per_s": N_ENVS / step_s,
        "launches_ppo": ppo_launches["pbd_step"],
        "launches_by_path": {"ant env.step": launches, "PPO ant": ppo_launches["pbd_step"],
                             **{f"{name} env.step": r["launches"] for name, r in h_main.items()},
                             "PPO humanoid": h_launches["pbd_step"],
                             **{f"{CAPCAP_LABEL[name]} env.step": r["launches"]
                                for name, r in c_main.items()},
                             "PPO v1 halfcheetah": c_launches["pbd_step"],
                             **{f"{name} env.step": r["launches"] for name, r in f_main.items()},
                             "PPO reacher": f_launches["pbd_step"],
                             **{f"{name} env.step": r["launches"] for name, r in g_main.items()},
                             "PPO grasp": g_launches["pbd_step"],
                             **{f"{name} env.step": r["launches"] for name, r in b_main.items()},
                             "PPO fetch": b_launches["pbd_step"],
                             **{f"{name} (legacy spring) {'sys' if 'sys_step_ms' in r else 'env'}"
                                f".step": r["launches"] for name, r in s_main.items()},
                             "PPO spring ant": s_launches["pbd_step"]},
        "by_scene": {
            "ant": {"ms": kernel_ms, "ms_host_issued": pbd_by_envs[N_ENVS]["host"],
                    "ms_by_envs": pbd_by_envs, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err_by_field": errs,
                    "outlier_envs_decided_by_rounding": outliers, "launch": pbd_launch,
                    "main_path": ant_main, "profile": ant_profile},
            **{name: {"ms": r["ms_by_envs"][N_ENVS]["graph"],
                      "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                      "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                      "checks": r["checks"], "launch": h_launch[name],
                      "main_paths": {k: h_main[k] for k in HUMANOID_MAIN_PATHS[name]},
                      "launches_ppo": h_launches["pbd_step"] if name == "humanoid" else None}
               for name, r in h_scene.items()},
            **{CAPCAP_LABEL[name]: {
                "ms": r["ms_by_envs"][N_ENVS]["graph"],
                "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                "checks": r["checks"],
                "launch": c_launch[name], "main_path": c_main[name],
                "launches_ppo": c_launches["pbd_step"] if name == "halfcheetah" else None}
               for name, r in c_scene.items()},
            **{name: {"ms": r["ms_by_envs"][N_ENVS]["graph"],
                      "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                      "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                      "checks": r["checks"], "launch": f_launch[name],
                      "main_path": f_main[name],
                      "launches_ppo": f_launches["pbd_step"] if name == "reacher" else None}
               for name, r in f_scene.items()},
            **{name: {"ms": r["ms_by_envs"][N_ENVS]["graph"],
                      "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                      "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                      "checks": r["checks"], "launch": g_launch[name],
                      "main_path": g_main[name],
                      "launches_ppo": g_launches["pbd_step"] if name == "grasp" else None}
               for name, r in g_scene.items()},
            **{name: {"ms": r["ms_by_envs"][N_ENVS]["graph"],
                      "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                      "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                      "checks": r["checks"], "launch": b_launch[name],
                      "main_path": b_main[name],
                      "launches_ppo": b_launches["pbd_step"] if name == "fetch" else None}
               for name, r in b_scene.items()},
            **{f"{name} (legacy spring)": {
                "ms": r["ms_by_envs"][N_ENVS]["graph"],
                "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                "checks": r["checks"], "launch": s_launch[name], "main_path": s_main[name],
                "launches_ppo": s_launches["pbd_step"] if name == "ant" else None}
               for name, r in s_scene.items()},
            "swimmer_twister": {"checks": {STATES[1]: g["twister"]}},
        },
        "card": name_limit,
    },
        fused_entry("fwd", "brax_tpu/training/fused_mlp.py:204",
                    "brax_tpu/training/fused_mlp.py::_fwd_kernel"),
        fused_entry("bwd", "brax_tpu/training/fused_mlp.py:247",
                    "brax_tpu/training/fused_mlp.py::_bwd_kernel"),
        {
            "name": "gen_step",
            "route": "cuda",
            "source": "brax_torch/csrc/gen_step.cu",
            "replaces": "brax_tpu/v2/generalized/kernels.py:1164",
            "replaces_function": "brax_tpu/v2/generalized/kernels.py::_build_tile_frames",
            "launches": gen_launches,
            "max_abs_err": max(max(c[0].values()) for c in gen_checks.values()),
            "max_abs_err_by_check": {k: c[0] for k, c in gen_checks.items()},
            "max_abs_err_within_tolerance": max(max(c[1].values()) for c in gen_checks.values()),
            "tolerance": GEN_TOLERANCE,
            "multi_frame_bounds": GEN_MULTI_FRAME_BOUNDS,
            "outlier_envs_decided_by_rounding": {k: c[2] for k, c in gen_checks.items()},
            "bit_identical_envs": {k: c[3] for k, c in gen_checks.items()},
            "max_outliers": GEN_MAX_OUTLIERS,
            "contact_share": {"after 10 steps": gen_contact, "lowered": low_contact},
            "frames_per_launch": GEN_FRAMES,
            "ms": gen_ms,
            "plain_ms": gen_plain_ms,
            "bound_ms": gen_bound_ms,
            "bound_by": gen_bound_by,
            "library_ms": None,
            "ops": gen_ops,
            "bytes": gen_bytes,
            "reference_static_flops_per_env_step": GEN_REFERENCE_FLOPS,
            "env_steps_per_s": N_ENVS / gen_step_s,
            "profile": gen_profile,
            "design": "a warp per env, its workspace in shared memory",
            "envs_per_block": gen_launches_by_scene["ant"][f"at_{N_ENVS}"]["envs_per_block"],
            "smem_bytes_per_env": gen_launches_by_scene["ant"]["smem_bytes_per_env"],
            "smem_bytes_per_block": gen_launches_by_scene["ant"][f"at_{N_ENVS}"][
                "smem_bytes_per_block"],
            "launch": gen_launches_by_scene["ant"],
            "ms_by_envs_and_envs_per_block": sweep,
            "launches_by_path": {"v2 ant env.step": gen_launches,
                                 "PPO v2 ant": v2_launches["gen_step"],
                                 **{f"v2 {name} env.step": r["launches"]
                                    for name, r in v2_records.items()}},
            "by_env": {name: {
                **record,
                "max_abs_err": max(max(c[0].values()) for c in v2_checks[name].values()),
                "max_abs_err_by_check": {k: c[0] for k, c in v2_checks[name].items()},
                "outlier_envs_decided_by_rounding": {k: c[2] for k, c in v2_checks[name].items()},
                "bit_identical_envs": {k: c[3] for k, c in v2_checks[name].items()},
                "contact_share_lowered": v2_contact[name],
                "launch": gen_launches_by_scene[name],
            } for name, record in v2_records.items()},
            "card": name_limit,
        },
        {
            "name": "probe_copy_plus_one",
            "route": "cuda",
            "source": "brax_torch/csrc/probe.cu",
            "replaces": "tools/probe_pallas_overhead.py:52",
            "replaces_function": "tools/probe_pallas_overhead.py::copy_k (trivial :52, "
                                 "gridded :62)",
            "launches": probe_launches["probe_copy_plus_one"],
            "replayed_launches": probe_replayed["probe_copy_plus_one"],
            "launches_counts": "wrapper calls that reached the kernel, host-issued and "
                               "captured into a graph; graph replays under replayed_launches",
            "launches_on_env_and_ppo_paths": probe_on_paths["probe_copy_plus_one"],
            "max_abs_err": max(copy_errs.values()),
            "tolerance": "exact",
            "shape": "[8, 128] f32, one block",
            "ms": probe_times["trivial_us"]["graph"] / 1e3,
            "ms_host_issued": probe_times["trivial_us"]["host"] / 1e3,
            "plain_ms": copy_plain_ms,
            "bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": probe_times["torch_add_trivial_us"]["graph"] / 1e3,
            "library_ms_host_issued": probe_times["torch_add_trivial_us"]["host"] / 1e3,
            "library": "torch.add(x, 1, out=o), PyTorch's eager kernel, graph-replayed",
            "us_per_launch": {k: probe_times[k] for k in ("trivial_us", "grid10_us",
                                                           "grid40_us")},
            "card": name_limit,
        },
        {
            "name": "probe_dot_chain",
            "route": "cuda",
            "source": "brax_torch/csrc/probe.cu",
            "replaces": "tools/probe_pallas_overhead.py:84",
            "replaces_function": "tools/probe_pallas_overhead.py::chain_k (dotchain :84, "
                                 "dotchain5120 :99)",
            "launches": probe_launches["probe_dot_chain"],
            "replayed_launches": probe_replayed["probe_dot_chain"],
            "launches_counts": "wrapper calls that reached the kernel, host-issued and "
                               "captured into a graph; graph replays under replayed_launches",
            "launches_on_env_and_ppo_paths": probe_on_paths["probe_dot_chain"],
            "max_abs_err": max(chain_errs.values()),
            "max_abs_err_by_shape": {f"[{r}, 256] k={k}": e for (r, k), e in chain_errs.items()},
            "tolerance": {"bf16_rel_to_max": BF16_REL},
            "shape": f"[5120, 256] @ [256, 256], k={k_main}",
            "ms": probe_times[f"dotchain5120_{k_main}_us"]["graph"] / 1e3,
            "ms_host_issued": probe_times[f"dotchain5120_{k_main}_us"]["host"] / 1e3,
            "plain_ms": chain_plain_ms,
            "bound_ms": probe_bound[5120, k_main][0],
            "bound_by": probe_bound[5120, k_main][1],
            "library_ms": None,
            "cublas_chain_ms": probe_times[f"cublas_dotchain5120_{k_main}_us"]["graph"] / 1e3,
            "hgmma_instructions": hgmma,
            "design": "wgmma m64n128k16 from shared memory, two warpgroups per 64-row tile",
            "ms_by_shape": {f"[{r}, 256] k={k}": t for (r, k), t in chain_times.items()},
            "us_per_launch": {k: v for k, v in probe_times.items() if "dotchain" in k},
            "bound_ms_by_shape": {f"[{r}, 256] k={k}": b[0] for (r, k), b in probe_bound.items()},
            "fused_mlp_fwd_value_5120_us": probe_times["fwd1_us"],
            "card": name_limit,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

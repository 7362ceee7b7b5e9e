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
   plain versions, PPO env-steps/s with the fused kernels on (the main
   path's run) and off, and profiles one training step with them on;
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
9g. the composer (brax_torch/composer) and the PBD kernel past one warp
   (PBD_WIDE: an env a block of 64-256 threads, its lanes exchanging through
   shared memory): the 2-agent chase (64 lanes) and the 4-agent chase of
   brax_torch/tools/bench_composer.py (256 lanes) held against the twin at
   4096 envs from a reset, after 10 twin steps and with the ants
   overlapping (pbd_parity.composer_states), over one pass and the whole
   step, each by the rule pbd_parity.RULES names; octopus_run (the wide
   route in legacy spring: PBD_WIDE with PBD_SPRING, 64 lanes) likewise
   from a reset, after 10 twin steps and jiggled (pbd_parity.
   octopus_states), over one substep and the whole step; env.step of every
   composer scene (ant_run, pro_ant_run, ant_push, ant_on_ball,
   halfcheetah_run, humanoid_run, ant_chase, chase, follow, sumo, the
   4-agent chase and octopus_run) at 4096 envs: 50 profiled steps with
   exactly one PBD launch each, finite observations, a reward an agent,
   the device busy share; the kernel timed per composer System as in step
   5 beside its bound, with its launch (registers, spills, shared memory,
   blocks per SM);
9h. MAPPO (brax_torch/composer/training/mappo.py) on the 2-agent ant chase
   and DIAYN (brax_torch/braxlines/train.py::train_vgcrl, PPO's
   auxiliary-learner hooks) on v1 ant, each at the ant recipe's batch
   settings for MAPPO_STEPS training steps and one eval of PPO_EVAL_ENVS
   envs: exact launch counts of the PBD kernel (the wide route for the
   chase) and of the fused MLP kernels (MAPPO a policy and a value chain
   per agent; DIAYN PPO's and the discriminator's, whose loss and relabel
   run once a training step), finite losses, every parameter moved (the
   discriminator's too), the joint action the env's width, env-steps/s;
9i. biggym (brax_torch/biggym, its registry filled by register_all and
   register_matches): every distinct System of its 12 scenes built (ptxas
   and launch printed; three are earlier scenes' Systems); its six new
   Systems (pbd_parity.BIGGYM_SCENES: one warp for race_proant_ant, the
   wide route at 64 and 128 lanes for the rest) held against the twin at
   4096 envs from a reset and after 10 twin steps (pbd_parity.
   biggym_states), over one pass and the whole step, by the rule
   pbd_parity.RULES names; env.step of every scene through
   biggym.create(name, batch_size=4096): 50 steps (5 profiled), one launch
   each, finite observations, a (N, 2) reward on the two-agent and match
   scenes; the kernel's timings, bound and plain version per new System;
   then ES (population 128, 256 envs) and ARS (60 directions, 120 envs,
   top 20) on v1 ant at their defaults (episodes of 1000 steps): two epochs
   and one eval of 128 envs each, exactly 3000 PBD launches and no fused
   MLP launch, finite scores, moved params, env-steps/s, and one profiled
   epoch of 50-step episodes and its eval (the device's kernels, busy
   share);
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
12b. the chain entry (gen_kernels.build_tiled_chain_fn: the carry q, qd,
   M^-1 kept in the kernel's (fields, N) layout, one launch a step, no
   transposes) on the v2 ant at 4096 envs: 3 chained steps bit for bit
   against chained gen_step and gen_step_plain calls, 50 chained steps with
   exactly one launch each, its ms per launch (graph-replayed and
   host-issued) beside gen_bound, and env-steps/s of the chain
   (host-issued and replayed from a CUDA graph) and of env.step in turns
   (brax_torch.tools.bench_v2_generalized.measure);
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
   times PPO env-steps/s with the fused kernels on (that run) and off and
   profiles one training step with them on;
15b. APG (the physics kernels forward, their autograd Functions'
   backwards: kernels.PBDStep runs the twin again, GenStep the pipeline's
   steps): on v1 ant at 4096 envs in contact (step 3's state), then grasp,
   fetch and the spring ant (steps 9d-9f's states), one step's gradients
   of a random linear functional of the six outputs, the kernel forward,
   equal to the twin's under autograd bit for bit (deterministic
   algorithms on), one launch per forward, the five inputs saved and
   nothing under no_grad; on ant also over APG_GRAD_STEPS steps by
   grad_parity.hold_rollout_grads' per-env rules, and timed; the same on
   the v2 ant at 2048 envs against autograd through five pipeline steps;
   then apg.train on v1 ant and v2 ant (8 steps each)
   at 2048 envs, an epoch each plain and truncated every 4 steps, with the exact launch
   counts and backward runs, finite nonzero gradients, moved parameters
   and a finite eval reward, and an {"apg": ...} line (seconds of rollout,
   backward and update, launches, the checks, peak memory);
15c. SAC: the fused MLP kernels at SAC's shapes (the critics' 257-wide
   input on humanoid, 24 on halfcheetah; the (256, 256) relu policies with
   34- and 12-wide heads; 256 rows, the SGD batch, and 128, the acting
   batch) against their plain versions by relu's rule (bf16 forward on
   every row, the f32 backward on the rows clear of the kink, the bf16
   backward on every row with dx off on no more rows than bf16 and f32
   flip at the kink and dW, db within bf16's own error, the bf16 forward
   and backward on every row with swish), each timed beside its
   bound and the cuBLAS chain; then sac.train at tools/run_curves.py's
   humanoid SAC recipe (copied into SAC_RECIPES; the full 1,048,576-row
   replay buffer) cut to its prefill, SAC_TRAINING_STEPS training steps and
   one evaluation, at the halfcheetah recipe, and on the v2 ant, with exact
   launch counts (per training step 1 physics, 37 fused forward and 20
   backward launches at 4 SGD steps), finite losses, moved parameters,
   env-steps/s, host seconds of the prefill, training steps and eval, peak
   memory, a profile of one humanoid training step, and a {"sac": ...}
   line;
16. reads the launch-overhead probe's counts, set to 0 before step 3, to
   show that no env or PPO path ran its kernels; holds them
   (brax_torch/csrc/probe.cu) against their plain versions, counts the
   HGMMA (wgmma) instructions in the dot chain's build (cuobjdump), then
   drives the probe (brax_torch.tools.probe_overhead.measure), which times
   every launch both issued by the host and replayed from a CUDA graph;
17. prints one JSON line listing every kernel (pbd_step's and gen_step's
   with the backward route their Functions take; pbd_step_wide, the wide
   route on the composer's multi-agent scenes, MAPPO's chase and
   octopus_run; gen_step_chain, the chain
   entry; the fused kernels' with SAC's shapes and launches) and, last,
   {"ok": true, "device": {...}}.

The CUDA sources are built at the start, one nvcc each, in parallel (the
generalized step once per v2 scene; the PBD step once per System, the
composer's among them); for each scene the generalized step's
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
from brax_torch.braxlines import discriminators as bl_discriminators
from brax_torch.braxlines import obs_indices as bl_obs_indices
from brax_torch.braxlines import train as bl_train
from brax_torch.braxlines.defaults import DEFAULT_PPO_PARAMS
from brax_torch.composer import envs as composer_envs
from brax_torch.composer.training import mappo
from brax_torch.sim import kernels
from brax_torch.tools import bench_v2_generalized as bench_v2
from brax_torch.tools import fused_turns, grad_parity
from brax_torch.tools import probe_overhead as probe
from brax_torch.tools.pbd_parity import (BIGGYM_SCENES, COMPOSER_SCENES, COMPOSER_WIDE,
                                         MAX_OUTLIERS, OCTOPUS, PERTURBED_COPIES, ROUNDING_NOISE,
                                         RULES, SPRING_SCENES, STATES, TOLERANCE, biggym_env,
                                         biggym_registry, biggym_states, capcap_share,
                                         capcap_state,
                                         composer_env, composer_scene, composer_states,
                                         contact_share, corners_down, fetch_states,
                                         fingertips_on_ball, force_scene_states, grasp_states,
                                         hold_capcap, max_errors, octopus_states, one_pass,
                                         spring_env, spring_states, twister_swimmer)
from brax_torch.training import fused_mlp
from brax_torch.training.agents.apg import networks as apg_networks
from brax_torch.training.agents.apg import train as apg
from brax_torch.training.agents.ars import train as ars
from brax_torch.training.agents.es import networks as es_networks
from brax_torch.training.agents.es import train as es
from brax_torch.training.agents.ppo import networks as ppo_networks
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.training.agents.sac import networks as sac_networks
from brax_torch.training.agents.sac import train as sac
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

N_ENVS = 4096
MAIN_STEPS = 200
# H100 SXM data sheet: HBM3 bandwidth, fp32 rate outside the tensor cores,
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the PPO recipes' MLP chains (make_ppo_networks' defaults): v1 ant's 87-wide
# observation, v2 ant's 27-wide one ("_v2"), humanoid's, halfcheetah's,
# grasp's and fetch's (brax_torch.tools.fused_turns.CHAINS)
CHAINS = fused_turns.CHAINS
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
# the PPO runs after the main path's (fused on), in turns: one with the fused
# MLP off (cut from off, on, off in PR 14, to make room for the APG phases
# in the time limit; the spread between runs was wider than the on/off gap)
PPO_TURNS = (False,)
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
# APG (the physics kernels forward, the autograd Functions' backwards): the
# main paths' batch and eval batch, each epoch's steps (cut from the
# recipes' 1000 for time: 64 and 32 took the APG phases 147-205 s, over the
# 3 minutes they may take, 48 and 24 took 167 s; cut to 32 and 16 to make
# room for the SAC phases in the time limit, and to 16 and 8 for the
# composer and chain phases (the whole script took 890-1074 s with 32 and
# 16); a step's backward is 0.5-0.7 s on v1, 0.8-1.2 s on v2), the
# truncation of the second epoch (4: inside both epochs, so steps run on
# from a cut state), the learner CLI's learning
# rate and clip (brax_tpu/training/learner.py:47-48), and the gradient
# checks' steps over which the kernel's trajectory and the twin's part
APG_ENVS, APG_EVAL_ENVS = 2048, 128
APG_EPISODE = {"v1 ant": 8, "v2 ant": 8}
APG_TRUNCATION = 4
APG_RECIPE = dict(learning_rate=5e-4, max_gradient_norm=1e9, normalize_observations=True)
APG_GRAD_STEPS = 4
# SAC: tools/run_curves.py's SAC recipes (SAC_CONFIGS and SAC_COMMON, copied:
# the port imports nothing of tools/), each main path cut only in
# num_timesteps (the prefill and SAC_TRAINING_STEPS training steps) and
# num_evals (1: one evaluation, at the end); the v2 ant runs the halfcheetah
# recipe for 2 training steps (gen_step under SAC)
SAC_RECIPES = {
    "humanoid": dict(num_timesteps=5 * 1048576, reward_scaling=10.0, discounting=0.99,
                     learning_rate=6e-4, num_envs=128, batch_size=256, min_replay_size=8192,
                     max_replay_size=1048576, grad_updates_per_step=4, episode_length=1000,
                     normalize_observations=True, num_evals=21),
    "halfcheetah": dict(num_timesteps=5 * 1048576, reward_scaling=5.0, discounting=0.99,
                        learning_rate=6e-4, num_envs=128, batch_size=256, min_replay_size=8192,
                        max_replay_size=1048576, grad_updates_per_step=4, episode_length=1000,
                        normalize_observations=True, num_evals=21),
}
SAC_TRAINING_STEPS = {"humanoid": 24, "halfcheetah": 4, "v2 ant": 2}
# the chains SAC launches (make_sac_networks' (256, 256) relu): the critics
# over obs and action (humanoid 240 + 17, halfcheetah 18 + 6), the policies
# with their 2 x actions heads; at the SGD batch (256 rows) and the acting
# and eval batch (128)
SAC_CHAINS = {"q_humanoid": [257, 256, 256, 1], "q_halfcheetah": [24, 256, 256, 1],
              "sac_policy_humanoid": [240, 256, 256, 34],
              "sac_policy_halfcheetah": [18, 256, 256, 12]}
SAC_SHAPES = [("q_humanoid", 256), ("q_halfcheetah", 256), ("sac_policy_humanoid", 256),
              ("sac_policy_humanoid", 128), ("sac_policy_halfcheetah", 256),
              ("sac_policy_halfcheetah", 128)]
# relu's kink (tests/test_torch_cuda.py): relu is held in bf16 forward and in
# f32 mode backward on the rows whose plain pre-activations all lie further
# than RELU_KINK from 0, in bf16 backward on every row by the bounds of
# check_relu_bf16_bwd; the bf16 backward whole with swish at the same shapes
RELU_KINK = 1e-5
# the chains MAPPO (the 2-agent chase: 164 observations, 8 actions an agent)
# and DIAYN (v1 ant's 87 observations and z; its discriminator on the root's
# x and y velocity) launch beside PPO's
TRAINER_CHAINS = {"policy_chase": [164] + [32] * 4 + [16], "value_chase": [164] + [256] * 5 + [1],
                  "policy_diayn": [89] + [32] * 4 + [16], "value_diayn": [89] + [256] * 5 + [1],
                  "disc_diayn": [2, 32, 32, 2]}
# the PBD kernel's batch sizes: PPO's eval, PPO's training batch, env.step's
PBD_TIMING_ENVS = (PPO_EVAL_ENVS, 2048, N_ENVS)
# the composer's Systems timed (ant_run's is v1 ant's; ant_chase's and follow's the
# chase's, table for table)
COMPOSER_TIMED = ("pro_ant_run", "ant_push", "ant_on_ball", "halfcheetah_run", "humanoid_run",
                  "chase", "sumo", "chase4", OCTOPUS)
# the wide scenes held against the twin (pbd_parity.RULES): the 2- and
# 4-agent chase from composer_states, octopus_run from octopus_states
COMPOSER_HELD = COMPOSER_WIDE + (OCTOPUS,)
# MAPPO on the 2-agent ant chase and DIAYN on v1 ant, training steps each
MAPPO_STEPS = 2
POP_EPISODE = 1000  # ES's and ARS's default episode_length
# the profiled epoch's episodes: the profiler reads ~220 kernels a step at
# ~0.2 ms each, 90 s for an epoch and eval of 1000 steps
POP_PROFILE_EPISODE = 50
DIAYN_STEPS = 2
COMPOSER_STEPS = 50
# of them profiled (the profiler's reading of a step's ~200-900 kernels
# costs ~0.2 ms each): 10 for the composer's scenes,
# BIGGYM_PROFILED for biggym's
COMPOSER_PROFILED = 10
BIGGYM_PROFILED = 5
COMPOSER_WARM = 2
# env.step calls timed by the host clock after the profiled ones
COMPOSER_TIMED_STEPS = 10
CHAIN_STEPS = 50
# twin steps after a reset of the state the composer Systems are timed on
# (every scene is on the ground, in contact, from its reset)
COMPOSER_SETTLE = 3
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
    """Registers, stack frame, spill bytes and static shared memory from a
    ptxas report."""
    regs = re.search(r"Used (\d+) registers", report)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", report)
    smem = re.search(r"(\d+) bytes smem", report)
    return {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
            "spill_store_bytes": int(frame.group(2)), "spill_load_bytes": int(frame.group(3)),
            "smem_bytes": int(smem.group(1)) if smem else 0}


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
    dims = CHAINS[name] if name in CHAINS else {**SAC_CHAINS, **TRAINER_CHAINS}[name]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((rows, dims[0]), generator=gen, device=DEVICE)
    ws = [(torch.rand((a, b), generator=gen, device=DEVICE) * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn((b,), generator=gen, device=DEVICE) * 0.1 for b in dims[1:]]
    g = torch.randn((rows, dims[-1]), generator=gen, device=DEVICE) / rows
    return dims, x, ws, bs, g


def check_chain(name, rows, bf16, activation="swish", kinds=("fwd", "bwd"),
                clear_of_kink=False):
    """Kernel against plain version, forward and backward (`kinds`); raises
    on any output outside the tolerance.  With `clear_of_kink`, on the rows
    whose plain f32 pre-activations all lie further than RELU_KINK from 0
    (relu's rule, tests/test_torch_cuda.py).  Returns {kind: error
    summary}."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    if clear_of_kink:
        zs = fused_mlp._forward_plain(x, ws, bs, activation, False, keep=True)[2]
        clear = torch.stack([z.abs().amin(dim=1) for z in zs]).amin(dim=0) > RELU_KINK
        x, g = x[clear].contiguous(), g[clear].contiguous()
    outputs = {}
    if "fwd" in kinds:
        y = fused_mlp.chain_fwd(x, ws, bs, activation, bf16)
        outputs["fwd"] = [("y", y, fused_mlp.chain_fwd_plain(x, ws, bs, activation, bf16))]
    if "bwd" in kinds:
        dx, dws, dbs = fused_mlp.chain_bwd(x, ws, bs, g, activation, bf16)
        pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x, ws, bs, g, activation, bf16)
        outputs["bwd"] = ([("dx", dx, pdx)]
                          + [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, pdws))]
                          + [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, pdbs))])
    torch.cuda.synchronize(DEVICE)
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
                raise AssertionError(f"fused_mlp {kind} {name}@{rows} {'bf16' if bf16 else 'f32'} "
                                     f"{activation}: {label} max |kernel - plain| "
                                     f"{float(err.max()):.3e} is {frac:.2f}x the tolerance")
            worst = max(worst, frac)
            max_err = max(max_err, float(err.max()))
            rel = max(rel, float(err.mean() / want.abs().mean()))
        summary[kind] = {"max_abs_err": max_err, "max_mean_rel_err": rel,
                         "fraction_of_tolerance": worst, "rows_held": x.shape[0]}
    return summary


def check_relu_bf16_bwd(name, rows):
    """relu's bf16 backward on every row (the mode SAC's path launches)
    against its plain version, held by what bf16 rounding moves at the kink:
    rows_off, the rows whose dx differs from the plain version's by more
    than BF16_REL of its largest value, may be at most rows_flipped, the
    rows on which the plain version's bf16 and f32 pre-activations put some
    unit on other sides of 0; each dW's and db's relative norm error may be
    at most the plain bf16 version's own against the plain f32 one, or
    F32_TOL's rtol where that is smaller (the last db: both sum the same
    f32 values, in other orders).  A kernel wrong on a tile, a column or
    relu' breaks every row it touches.  Returns {"bwd": summary}."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    got = fused_mlp.chain_bwd(x, ws, bs, g, "relu", True)
    plain = fused_mlp.chain_bwd_plain(x, ws, bs, g, "relu", True)
    plain_f32 = fused_mlp.chain_bwd_plain(x, ws, bs, g, "relu", False)
    z16, z32 = (fused_mlp._forward_plain(x, ws, bs, "relu", bf16, keep=True)[2]
                for bf16 in (True, False))
    torch.cuda.synchronize(DEVICE)
    flipped = torch.stack([((a > 0) != (b > 0)).any(dim=1) for a, b in zip(z16, z32)])
    rows_flipped = int(flipped.any(dim=0).sum())
    dx_err = (got[0] - plain[0]).abs()
    rows_off = int((dx_err.amax(dim=1) > BF16_REL * plain[0].abs().max()).sum())
    norm_err = lambda a, b: float((a - b).norm() / b.norm())
    outputs = [(f"{p}{i}", a, b, c) for p, j in (("dW", 1), ("db", 2))
               for i, (a, b, c) in enumerate(zip(got[j], plain[j], plain_f32[j]))]
    norms = {label: (norm_err(a, b), max(norm_err(b, c), F32_TOL["bwd"][0]))
             for label, a, b, c in outputs}
    summary = {"rows_held": rows, "rows_off": rows_off, "rows_flipped": rows_flipped,
               "max_abs_err": float(dx_err.max()),
               "norm_err_and_limit": norms,
               "fraction_of_tolerance": max(rows_off / max(rows_flipped, 1),
                                            *(e / lim for e, lim in norms.values()))}
    bad = [label for label, (e, lim) in norms.items() if e > lim]
    if rows_off > rows_flipped or bad:
        raise AssertionError(f"fused_mlp bwd {name}@{rows} bf16 relu: {rows_off} rows of dx off "
                             f"(at most {rows_flipped}); relative norm errors over their limits: "
                             f"{ {k: norms[k] for k in bad} }")
    return {"bwd": summary}


# elementwise operations of an activation and of its derivative, per element
ACT_OPS = {"swish": (4, 6), "relu": (1, 1)}


def chain_bound(dims, rows, bf16, backward, activation="swish"):
    """(bound_ms, bound_by, ops, bytes) of one chain call.

    Matmul operations at the bf16 tensor-core or the fp32 rate; elementwise
    ones (bias add 1, the activation (ACT_OPS: swish 4, relu 1), its
    derivative (swish' 6, relu' 1) and the product with it 1, db's sum 1
    per element) at the fp32 rate.  Bytes: each input read once, each output
    written once, float32.  The backward recomputes the forward but its last
    layer, then runs dW and dx for every layer."""
    pairs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    outs, hidden = sum(dims[1:]), sum(dims[1:-1])
    act, act_grad = ACT_OPS[activation]
    if backward:
        mm = 2 * rows * (sum(pairs[:-1]) + 2 * sum(pairs))
        elem = rows * ((outs - dims[-1]) + act * hidden + (act_grad + 1) * hidden + outs)
        n_bytes = 4 * (2 * rows * dims[0] + rows * dims[-1] + 2 * (sum(pairs) + outs))
    else:
        mm = 2 * rows * sum(pairs)
        elem = rows * (outs + act * hidden)
        n_bytes = 4 * (rows * dims[0] + sum(pairs) + outs + rows * dims[-1])
    ops_ms = (mm / (BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S) + elem / FP32_OPS_PER_S) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(ops_ms, bytes_ms), bound_by, mm + elem, n_bytes


def time_chain(name, rows, bf16, activation="swish"):
    """ms per call of each kernel and of the same chain as F.linear calls
    (cuBLAS, a yardstick) in the same precision, replayed from a CUDA graph
    (GRAPH_CALLS calls per graph: the card's time) and issued by the host
    (CUDA events over back-to-back calls: the wrapper's host cost
    included, "_host"), and of the plain versions, host-issued.  The
    cuBLAS backward replayed is its forward + autograd backward graph less
    its forward graph (a backward captures only beside its forward)."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    fwd = lambda *_: fused_mlp.chain_fwd(x, ws, bs, activation, bf16)
    bwd = lambda *_: fused_mlp.chain_bwd(x, ws, bs, g, activation, bf16)
    t = {
        "fwd": probe.graph_us(fwd, GRAPH_CALLS) / 1e3,
        "bwd": probe.graph_us(bwd, GRAPH_CALLS) / 1e3,
        "fwd_host": cuda_ms(fwd, 200, 20),
        "bwd_host": cuda_ms(bwd, 200, 20),
        "plain_fwd": cuda_ms(lambda: fused_mlp.chain_fwd_plain(x, ws, bs, activation, bf16),
                             50, 5),
        "plain_bwd": cuda_ms(lambda: fused_mlp.chain_bwd_plain(x, ws, bs, g, activation, bf16),
                             50, 5),
    }
    act = {"swish": F.silu, "relu": F.relu}[activation]
    dt = torch.bfloat16 if bf16 else torch.float32
    wl = [w.t().contiguous().to(dt).requires_grad_() for w in ws]
    bl = [b.to(dt).requires_grad_() for b in bs]
    xl, gl = x.to(dt).requires_grad_(), g.to(dt)

    def linear_chain(h):
        for i, (w, b) in enumerate(zip(wl, bl)):
            h = F.linear(h, w, b)
            if i < len(wl) - 1:
                h = act(h)
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
    """A network factory (`make`, by default PPO's) that keeps the networks
    it makes and a copy of the parameters each network's `init` returns."""

    def __init__(self, make=ppo_networks.make_ppo_networks, sides=("policy", "value")):
        self.make, self.sides = make, sides
        self.networks, self.initial = None, {}

    def factory(self, *args, **kwargs):
        self.networks = self.make(*args, **kwargs)
        for side in self.sides:
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


def profile_training_step(fused, environment="ant", preset="ant", run=None, prefix="ppo",
                          parts=("rollout", "sgd"), steps=2):
    """Device time, device-op count and top kernels of the last of `steps`
    training steps (the host range "ppo/training_step", which ends in a
    synchronise), and the host time of its rollout and SGD ranges; or of
    the last "{prefix}/training_step" of `run()` and its `parts`' ranges.
    `chip_smoke.py` profiles one step (steps=1: its process has run the
    recipe's PPO before, so nothing is built or first-called in it; the
    profiler reads a step's ~200k events at ~0.2 ms each).

    The episode is cut to PROFILE_EPISODE steps so that the run's one
    evaluation stays short; a training step does the same work at any
    episode length (auto-reset runs every step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if run is None:
            run_ppo(fused, steps=steps, environment=environment, preset=preset,
                    episode_length=PROFILE_EPISODE)
        else:
            run()
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = lambda name: sorted((e for e in events if e.name == name and e.device_type == cpu),
                                 key=lambda e: e.time_range.start)
    step = ranges(f"{prefix}/training_step")[-1]
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
    host = {part: sum(e.time_range.elapsed_us() for e in ranges(f"{prefix}/{part}") if inside(e))
            for part in parts}
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
    parts = " and ".join(f"{k} {us / 1e3:.1f} ms" for k, us in prof["host_us"].items())
    print(f"profile {tag}: {label}fused_mlp {mode}: one training step "
          f"{prof['step_us'] / 1e3:.1f} ms (host), of it {parts}; device busy "
          f"{prof['device_us'] / 1e3:.1f} ms "
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


def apg_counts():
    """The kernels' launch counts and the Functions' backward runs."""
    return {"pbd_step": kernels.pbd_step_launch.launches,
            "gen_step": gen_kernels.gen_step_soa.launches,
            "fused_mlp_fwd": fused_mlp.chain_fwd.launches,
            "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
            "pbd_step_backward_runs": kernels.PBDStep.backward_calls,
            "gen_step_backward_runs": gen_kernels.GenStep.backward_calls}


def zero_apg_counts():
    kernels.pbd_step_launch.launches = gen_kernels.gen_step_soa.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    kernels.PBDStep.backward_calls = gen_kernels.GenStep.backward_calls = 0


def pbd_grad_check(tag, label, sys_, qp, act, gen, rollout_steps=0, timed=False):
    """`kernels.PBDStep` on one state: (a) its gradients of a random linear
    functional of the six outputs, the kernel forward, equal the twin's
    under autograd bit for bit (deterministic algorithms on); (c) its
    forward is one launch, it saves its five inputs, and a step under
    no_grad saves nothing; (b) over `rollout_steps` steps the two agree by
    grad_parity.hold_rollout_grads' per-env rules; where `timed`, a step
    forward and backward, the Function's and the twin's."""
    ws = grad_parity.weights(grad_parity.pbd_outputs(*kernels.pbd_step_plain(sys_, qp, act)))
    with grad_parity.deterministic():
        before = kernels.pbd_step_launch.launches
        got = grad_parity.pbd_grads(sys_, qp, act, ws, kernels.pbd_step)
        launches = kernels.pbd_step_launch.launches - before
        want = grad_parity.pbd_grads(sys_, qp, act, ws, kernels.pbd_step_plain)
    torch.cuda.synchronize()
    same = grad_parity.bit_identical(got, want)
    leaf = act.clone().requires_grad_()
    (_, _), saved = grad_parity.saved_tensors(lambda: kernels.pbd_step(sys_, qp, leaf))
    with torch.no_grad():
        (out, _), saved_no_grad = grad_parity.saved_tensors(
            lambda: kernels.pbd_step(sys_, qp, leaf))
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    record = {"envs": qp.pos.shape[0], "bit_identical": same, "forward_launches": launches,
              "saved_with_grad": saved, "saved_under_no_grad": saved_no_grad, "finite": finite,
              "max_abs_grad": {k: float(g.abs().max()) for k, g in got.items()}}
    if not (same and finite and launches == 1 and saved == 5 and saved_no_grad == 0
            and out.pos.grad_fn is None):
        raise AssertionError(f"APG {label}: the PBD Function's check failed: {record}")
    if timed:
        record["fwd_bwd_ms"] = cuda_ms(
            lambda: grad_parity.pbd_grads(sys_, qp, act, ws, kernels.pbd_step), reps=2, warmup=1)
        record["plain_fwd_bwd_ms"] = cuda_ms(
            lambda: grad_parity.pbd_grads(sys_, qp, act, ws, kernels.pbd_step_plain), reps=2,
            warmup=1)
    if rollout_steps:
        record["rollout"] = grad_parity.hold_rollout_grads(sys_, qp, act, rollout_steps, gen)
    print(f"APG {tag}: pbd_step gradients, {label}: {record}")
    return record


def gen_grad_check(tag, device):
    """`generalized.kernels.GenStep` on the v2 ant at APG_ENVS envs from a
    reset: (a) its gradients, the kernel forward, equal those of autograd
    through GEN_FRAMES pipeline steps bit for bit; (c) one launch forward,
    the State's float leaves and the action saved, nothing under no_grad;
    a step forward and backward timed, the Function's and the pipeline's."""
    env = v2_envs.create("ant", batch_size=APG_ENVS, device=device)
    state = env.reset(torch.Generator(device=device).manual_seed(0)).pipeline_state
    act = torch.rand((APG_ENVS, 8), generator=torch.Generator(device=device).manual_seed(1),
                     device=device) * 2 - 1
    sys_ = env.unwrapped.sys
    ws = grad_parity.weights(gen_kernels.float_leaves(state))
    with grad_parity.deterministic():
        before = gen_kernels.gen_step_soa.launches
        got = grad_parity.gen_grads(sys_, state, act, GEN_FRAMES, ws, "function")
        launches = gen_kernels.gen_step_soa.launches - before
        want = grad_parity.gen_grads(sys_, state, act, GEN_FRAMES, ws, "pipeline")
    torch.cuda.synchronize()
    same = grad_parity.bit_identical(got, want)
    leaf = act.clone().requires_grad_()
    _, saved = grad_parity.saved_tensors(
        lambda: gen_kernels.kernel_step(sys_, state, leaf, GEN_FRAMES))
    with torch.no_grad():
        out, saved_no_grad = grad_parity.saved_tensors(
            lambda: gen_kernels.kernel_step(sys_, state, leaf, GEN_FRAMES))
    n_leaves = len(gen_kernels.float_leaves(state))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    record = {"envs": APG_ENVS, "bit_identical": same, "forward_launches": launches,
              "saved_with_grad": saved, "saved_under_no_grad": saved_no_grad, "finite": finite,
              "float_leaves": n_leaves, "max_abs_grad_act": float(got[0].abs().max())}
    if not (same and finite and launches == 1 and saved == n_leaves + 1 and saved_no_grad == 0
            and out.q.grad_fn is None):
        raise AssertionError(f"APG: the generalized Function's check failed: {record}")
    record["fwd_bwd_ms"] = cuda_ms(lambda: grad_parity.gen_grads(
        sys_, state, act, GEN_FRAMES, ws, "function"), reps=2, warmup=1)
    record["pipeline_fwd_bwd_ms"] = cuda_ms(lambda: grad_parity.gen_grads(
        sys_, state, act, GEN_FRAMES, ws, "pipeline"), reps=2, warmup=1)
    print(f"APG {tag}: gen_step gradients, v2 ant: {record}")
    return record


def apg_main_path(tag, label, environment, truncation=None):
    """`apg.train` on `environment` at APG_ENVS envs for one epoch of
    APG_EPISODE[label] steps (with an evaluation of APG_EVAL_ENVS envs
    before it unless `truncation` is given, and one after): finite nonzero
    gradients, moved parameters, a finite eval reward, and launch counts
    and backward runs (counts set to 0 just before, read just after) equal
    to what the run implies."""
    steps = APG_EPISODE[label]
    evals = 1 if truncation else 2
    recorder = InitRecorder(apg_networks.make_apg_networks, ("policy",))
    zero_apg_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, (_, params), metrics = apg.train(
        environment, episode_length=steps, num_envs=APG_ENVS, num_eval_envs=APG_EVAL_ENVS,
        num_evals=evals, truncation_length=truncation, seed=0, device=DEVICE,
        network_factory=recorder.factory, **APG_RECIPE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = apg_counts()
    graded = steps - (steps // truncation if truncation else 0)
    physics = "pbd_step" if label.startswith("v1") else "gen_step"
    want = {k: 0 for k in counts}
    want.update({physics: (evals + 1) * steps, "fused_mlp_fwd": (evals + 1) * steps,
                 "fused_mlp_bwd": graded, f"{physics}_backward_runs": graded})
    moved = min(float((params[k] - v).abs().max()) for k, v in recorder.initial["policy"].items())
    grad_norm, reward = metrics["training/grad_norm"], metrics["eval/episode_reward"]
    if counts != want:
        raise AssertionError(f"APG {label}: counts {counts}, expected {want}")
    if not (np.isfinite(grad_norm) and grad_norm > 0 and np.isfinite(reward) and moved > 0):
        raise AssertionError(f"APG {label}: grad_norm {grad_norm}, eval reward {reward}, "
                             f"smallest parameter change {moved}")
    record = {"steps": steps, "envs": APG_ENVS, "truncation_length": truncation,
              "seconds": seconds, "launches": counts, "grad_norm": grad_norm,
              "unclipped_grad_norm": metrics["training/unclipped_grad_norm"],
              "params_norm": metrics["training/params_norm"], "eval_episode_reward": reward,
              "smallest_param_change": moved,
              **{k: metrics[f"training/{k}"] for k in ("rollout_s", "backward_s", "update_s")},
              "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print(f"main path APG {label} {tag}: one epoch of {steps} steps at {APG_ENVS} envs "
          f"(truncation {truncation}) + {evals} eval(s) of {APG_EVAL_ENVS} envs in {seconds:.1f} "
          f"s: rollout {record['rollout_s']:.3f} s, backward {record['backward_s']:.3f} s, update "
          f"{record['update_s']:.4f} s; launches and backward runs {counts} (as expected); "
          f"grad_norm {grad_norm:.5g}, eval/episode_reward {reward:.5g}; every parameter moved "
          f"(smallest max change {moved:.3e}); peak memory "
          f"{record['max_memory_allocated'] / 2**30:.3f} GiB")
    return record


def apg_paths(tag, phase, pbd_states, gen):
    """The APG phases: the PBD Function's gradient checks on each of
    `pbd_states` ({label: (sys, qp, act)}, v1 ant first: over
    APG_GRAD_STEPS steps too, and timed), the generalized Function's on v2
    ant, then the main paths, apg.train on v1 and v2 ant, each a plain
    epoch and one truncated every APG_TRUNCATION steps."""
    phase("APG: pbd_step gradients")
    pbd = {label: pbd_grad_check(tag, label, sys_, qp, act, gen,
                                 rollout_steps=APG_GRAD_STEPS if label == "ant" else 0,
                                 timed=label == "ant")
           for label, (sys_, qp, act) in pbd_states.items()}
    phase("APG: gen_step gradients")
    gen_check = gen_grad_check(tag, DEVICE)
    phase("main path: APG on v1 ant")
    v1 = {"plain": apg_main_path(tag, "v1 ant", "ant"),
          "truncated": apg_main_path(tag, "v1 ant", "ant", APG_TRUNCATION)}
    phase("main path: APG on v2 ant")
    v2 = {"plain": apg_main_path(tag, "v2 ant", v2_ant),
          "truncated": apg_main_path(tag, "v2 ant", v2_ant, APG_TRUNCATION)}
    return {"pbd_step_gradients": pbd, "gen_step_gradients": gen_check, "v1 ant": v1,
            "v2 ant": v2}


def sac_chains(tag, phase):
    """The fused kernels at SAC's shapes (SAC_SHAPES; relu): the bf16
    forward on every row, the f32 backward on the rows clear of relu's kink,
    the bf16 backward on every row by check_relu_bf16_bwd's bounds, and the
    bf16 forward and backward on every row with swish (no kink);
    each shape's launch, and its times (graph-replayed and host-issued,
    relu, bf16) beside its bound, its plain version and the cuBLAS chain."""
    phase("SAC: fused Q-route parity and timings")
    checks, times, bounds, plans = {}, {}, {}, {}
    for name, rows in SAC_SHAPES:
        checks[name, rows] = c = {
            "relu_bf16": check_chain(name, rows, True, "relu", kinds=("fwd",)),
            "relu_f32_clear_of_kink": check_chain(name, rows, False, "relu",
                                                  clear_of_kink=True),
            "swish_bf16": check_chain(name, rows, True, "swish")}
        for mode, r in c.items():
            for kind, e in r.items():
                print(f"parity fused_mlp_{kind} {name}@{rows} {mode}: max|kernel - plain| = "
                      f"{e['max_abs_err']:.3e} over {e['rows_held']} rows, mean|err|/mean|plain| "
                      f"up to {e['max_mean_rel_err']:.3e}, {e['fraction_of_tolerance']:.3f} of the "
                      f"tolerance")
        c["relu_bf16_every_row"] = r = check_relu_bf16_bwd(name, rows)
        e = r["bwd"]
        print(f"parity fused_mlp_bwd {name}@{rows} relu_bf16_every_row: dx off on "
              f"{e['rows_off']} of {rows} rows (at most {e['rows_flipped']}, the rows where bf16 "
              f"and f32 put a pre-activation on other sides of 0); relative norm error and its "
              f"limit " + ", ".join(f"{k} {a:.2e} / {b:.2e}"
                                    for k, (a, b) in e["norm_err_and_limit"].items())
              + f"; {e['fraction_of_tolerance']:.3f} of the tolerance")
        times[name, rows] = t = time_chain(name, rows, True, "relu")
        for kind in ("fwd", "bwd"):
            plans[kind, name, rows] = {k: v for k, v in fused_mlp.card_plan(
                tuple(SAC_CHAINS[name]), rows, DEVICE, kind == "bwd").items() if k != "scratch"}
            bounds[kind, name, rows] = b = chain_bound(SAC_CHAINS[name], rows, True, kind == "bwd",
                                                       "relu")
            print(f"launch fused_mlp_{kind} {name}@{rows} bf16: {plans[kind, name, rows]}")
            print(f"timing {tag}: fused_mlp_{kind} {name}@{rows} bf16 relu: kernel "
                  f"{t[kind]:.4f} ms graph-replayed ({t[kind + '_host']:.4f} host-issued), plain "
                  f"{t['plain_' + kind]:.4f} ms, F.linear chain (cuBLAS) "
                  f"{t['cublas_' + kind]:.4f} ms graph-replayed "
                  f"({t['cublas_' + kind + '_host']:.4f} host-issued); bound {b[0]:.5f} ms by "
                  f"{b[1]} ({b[2]:.4g} ops, {b[3]} bytes)")
    return {"checks": checks, "times": times, "bounds": bounds, "plans": plans}


def run_sac(recipe_name, environment, steps, **kw):
    """sac.train at SAC_RECIPES[recipe_name] cut to the prefill and `steps`
    training steps and one evaluation (`kw` overrides more).  Returns (the
    settings, the cuts, train's result)."""
    p = dict(SAC_RECIPES[recipe_name])
    p.update(kw)
    prefill = -(-p["min_replay_size"] // p["num_envs"])
    cut = {"num_timesteps": (prefill + steps) * p["num_envs"] * p.get("action_repeat", 1),
           "num_evals": 1}
    p.update(cut)
    return p, cut, sac.train(environment, seed=0, device=DEVICE, **p)


def sac_launches(p, steps):
    """The launches of a SAC run: the policy and the physics once per
    prefill actor step, then per training step one actor step and
    grad_updates_per_step SGD steps of 9 forward launches (the policy in
    each of the three losses, the critics in the critic and actor losses,
    the target critics) and 5 backward (the critics in the critic and actor
    losses, the policy in the actor's), then one evaluation's steps."""
    prefill = -(-p["min_replay_size"] // p["num_envs"])
    gu, eval_steps = p["grad_updates_per_step"], p["episode_length"]
    return {"fused_mlp_fwd": prefill + steps * (1 + 9 * gu) + eval_steps,
            "fused_mlp_bwd": steps * 5 * gu, "physics": prefill + steps + eval_steps}


def sac_main_path(tag, label, environment, recipe_name):
    """`sac.train` on `environment` at SAC_RECIPES[recipe_name], cut to
    SAC_TRAINING_STEPS[label] training steps and one evaluation: launch
    counts (set to 0 just before, read just after) equal to sac_launches,
    finite losses and eval reward, every parameter moved, the replay
    buffer's cursors; env-steps/s, host seconds of the prefill, the
    training steps and the evaluation, and peak memory."""
    steps = SAC_TRAINING_STEPS[label]
    physics = gen_kernels.gen_step_soa if label.startswith("v2") else kernels.pbd_step_launch
    recorder = InitRecorder(sac_networks.make_sac_networks, ("policy", "q"))
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    kernels.pbd_step_launch.launches = gen_kernels.gen_step_soa.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p, cut, (_, (_, params), metrics) = run_sac(recipe_name, environment, steps,
                                                network_factory=recorder.factory)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                "fused_mlp_bwd": fused_mlp.chain_bwd.launches, "physics": physics.launches}
    want = sac_launches(p, steps)
    if launches != want:
        raise AssertionError(f"SAC {label}: launches {launches}, expected {want}")
    losses = {k: metrics[f"training/{k}"] for k in ("critic_loss", "actor_loss", "alpha_loss",
                                                    "alpha")}
    reward = metrics["eval/episode_reward"]
    if not all(np.isfinite(v) for v in (*losses.values(), reward)):
        raise AssertionError(f"SAC {label}: losses {losses}, eval reward {reward}")
    nets = recorder.networks
    now = {"policy": dict(nets.policy_network.mlp.named_parameters()),
           "q": dict(nets.q_network.module.named_parameters())}
    moved = {f"{side}.{k}": float((now[side][k].detach() - v).abs().max())
             for side in ("policy", "q") for k, v in recorder.initial[side].items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"SAC {label}: parameters that did not change: "
                             f"{[k for k, v in moved.items() if not v > 0]}")
    if any(not torch.equal(params[k], v.detach()) for k, v in now["policy"].items()):
        raise AssertionError(f"SAC {label}: train returned other policy params than it trained")
    prefill = -(-p["min_replay_size"] // p["num_envs"])
    rows = (prefill + steps) * p["num_envs"]
    if (metrics["training/buffer_current_size"] > rows
            or metrics["training/buffer_current_size"] <= prefill * p["num_envs"]):
        raise AssertionError(f"SAC {label}: buffer size {metrics['training/buffer_current_size']}")
    epoch_s = steps * p["num_envs"] / metrics["training/sps"]
    record = {"recipe": recipe_name, "cut": cut, "training_steps": steps,
              "prefill_actor_steps": prefill, "seconds": seconds, "launches": launches,
              "expected_launches": want, "physics_kernel": physics.__name__,
              "losses": losses, "eval_episode_reward": reward,
              "sps": metrics["training/sps"],
              "sps_after_first": metrics.get("training/sps_after_first"),
              "prefill_s": metrics["training/walltime"] - epoch_s, "training_steps_s": epoch_s,
              "eval_s": metrics["eval/epoch_eval_time"],
              "buffer_rows": p["max_replay_size"],
              # a row: obs, action, reward, discount, next obs, truncation
              "buffer_bytes": p["max_replay_size"] * 4 * (
                  recorder.initial["policy"]["hidden_0.kernel"].shape[0]
                  + recorder.initial["q"]["MLP_0.hidden_0.kernel"].shape[0] + 3),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "smallest_param_change": min(moved.values())}
    print(f"main path SAC {label} {tag}: {recipe_name} recipe cut to {cut} (prefill "
          f"{prefill} actor steps, {steps} training steps of {p['grad_updates_per_step']} SGD "
          f"steps, one eval of 128 envs x {p['episode_length']} steps) in {seconds:.1f} s: "
          f"training/sps {record['sps']:.1f} (after the first step "
          f"{record['sps_after_first']}), host s prefill {record['prefill_s']:.3f}, training "
          f"steps {epoch_s:.3f}, eval {record['eval_s']:.3f}; launches {launches} (as "
          f"expected); losses {losses}, eval/episode_reward {reward:.5g}; every parameter "
          f"moved (smallest max change {record['smallest_param_change']:.3e}); replay buffer "
          f"{record['buffer_rows']} rows, {record['buffer_bytes'] / 1e9:.2f} GB; peak memory "
          f"{record['max_memory_allocated'] / 2**30:.3f} GiB")
    return record


def sac_paths(tag, phase):
    """The SAC phases: the fused kernels at SAC's shapes, then sac.train on
    humanoid (its recipe; a training step profiled apart), halfcheetah and
    the v2 ant (the halfcheetah recipe)."""
    chains = sac_chains(tag, phase)
    phase("main path: SAC on humanoid")
    runs = {"humanoid": sac_main_path(tag, "humanoid", "humanoid", "humanoid")}
    p = SAC_RECIPES["humanoid"]
    # the second of two training steps, profiled: a prefill of one SGD
    # sample's rows and a PROFILE_EPISODE-step eval keep the trace short
    prof = print_profile(tag, "SAC humanoid, ", "on", profile_training_step(
        True, run=lambda: run_sac("humanoid", "humanoid", 2, episode_length=PROFILE_EPISODE,
                                  min_replay_size=p["batch_size"] * p["grad_updates_per_step"]),
        prefix="sac", parts=("sgd",)))
    runs["humanoid"]["profile"] = {k: v for k, v in prof.items() if k not in ("top", "host_top")}
    phase("main path: SAC on halfcheetah")
    runs["halfcheetah"] = sac_main_path(tag, "halfcheetah", "halfcheetah", "halfcheetah")
    phase("main path: SAC on v2 ant")
    runs["v2 ant"] = sac_main_path(tag, "v2 ant", v2_ant, "halfcheetah")
    return {"chains": chains, "runs": runs}



def composer_main_path(tag, scene, env=None, label="composer", profiled=COMPOSER_PROFILED):
    """env.step of a composer scene at N_ENVS (or of `env`, a biggym scene's):
    COMPOSER_WARM steps, then COMPOSER_STEPS steps with exactly one PBD
    launch each (counts set to 0 just before, read just after), the first
    `profiled` of them profiled, then COMPOSER_TIMED_STEPS steps timed by
    the host clock; finite observations and a (N, agents) or (N,) reward;
    the device busy share (the profiled device time per step over the
    unprofiled host time per step).  Returns the record."""
    if env is None:
        env = composer_scene(scene, N_ENVS, DEVICE, episode_length=1000, auto_reset=True)
    inner = env.unwrapped
    state = env.reset(torch.Generator(device=DEVICE).manual_seed(1))
    act_gen = torch.Generator(device=DEVICE).manual_seed(2)
    act = lambda: torch.rand((N_ENVS, env.action_size), generator=act_gen, device=DEVICE) * 2 - 1
    for _ in range(COMPOSER_WARM):
        state = env.step(state, act())
    kernels.pbd_step_launch.launches = 0
    from torch.profiler import ProfilerActivity, profile

    # the device's kernels only: recording every host op of 50 steps costs
    # the profiler minutes across the scenes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            state = env.step(state, act())
        torch.cuda.synchronize()
    for _ in range(COMPOSER_STEPS - profiled):
        state = env.step(state, act())
    torch.cuda.synchronize()
    launches = kernels.pbd_step_launch.launches
    if launches != COMPOSER_STEPS:
        raise AssertionError(f"{COMPOSER_STEPS} {scene} env steps made {launches} launches")
    device_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(device_us(e) for e in events) / profiled
    kernels_per_step = sum(e.count for e in events) / profiled
    pbd_us = sum(device_us(e) for e in events if "pbd_step" in e.key) / profiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COMPOSER_TIMED_STEPS):
        state = env.step(state, act())
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / COMPOSER_TIMED_STEPS * 1e3
    agents = len(getattr(inner, "agent_names", ()))
    want_reward = (N_ENVS, agents) if agents else (N_ENVS,)
    if tuple(state.reward.shape) != want_reward:
        raise AssertionError(f"{scene} reward shape {tuple(state.reward.shape)}")
    if not bool(torch.isfinite(state.obs).all()) or state.obs.shape != (
            N_ENVS, env.observation_size):
        raise AssertionError(f"{scene} obs {tuple(state.obs.shape)} not finite or not "
                             f"{env.observation_size} wide")
    rec = {"launches": launches, "env_step_ms": step_ms, "env_steps_per_s": N_ENVS / step_ms * 1e3,
           "device_us_per_step": dev_us, "pbd_step_us_per_step": pbd_us,
           "kernels_per_step": kernels_per_step,
           "busy_share": dev_us / (step_ms * 1e3) if dev_us else None,
           "obs_width": env.observation_size, "action_size": env.action_size,
           "agents": agents, "done_fraction": float(state.done.mean()),
           "wide": kernels.plan(inner.sys).wide}
    busy = f"{rec['busy_share']:.3f}" if dev_us else "not measured (no device time recorded)"
    print(f"main path {label} {scene}: {COMPOSER_STEPS} env.step calls ({profiled} profiled), "
          f"{launches} pbd_step launches, obs {tuple(state.obs.shape)} finite, reward "
          f"{tuple(state.reward.shape)}; env.step {step_ms:.4f} ms/step, "
          f"{rec['env_steps_per_s']:.1f} env-steps/s (host clock, {COMPOSER_TIMED_STEPS} "
          f"steps); device "
          f"{dev_us:.1f} us/step ({pbd_us:.1f} of it pbd_step), {kernels_per_step:.0f} kernels "
          f"a step, busy {busy} {tag}")
    return rec


def composer_paths(tag, phase):
    """The composer phases: the wide route (PBD_WIDE) against the twin on the
    2- and 4-agent chase at N_ENVS from pbd_parity.composer_states and on
    octopus_run (with PBD_SPRING) from pbd_parity.octopus_states, over one
    pass (octopus_run: one substep) and the whole step, by pbd_parity.RULES;
    env.step of every composer scene (composer_main_path); the kernel's
    timings, bound and plain version per System (COMPOSER_TIMED) and each
    launch."""
    device = DEVICE
    phase("composer: wide pbd_step parity")
    gen = torch.Generator(device=device).manual_seed(7)
    w_checks = {}
    for name in COMPOSER_HELD:
        env_ = composer_env(name, N_ENVS, device)
        checks_w = {}
        held = (octopus_states(env_, N_ENVS, 0, device) if name == OCTOPUS
                else composer_states(name, env_, N_ENVS, 0, device))
        for state, (qp, act) in held.items():
            share = contact_share(env_.sys, qp, act)
            # octopus_run has no capsule-capsule pairs
            overlap = 0.0 if name == OCTOPUS else capcap_share(env_.sys, qp)
            rule = RULES[name][state]
            print(f"parity state: composer {name}, {N_ENVS} envs, {state}, action "
                  f"{tuple(act.shape)}, {share:.3f} in contact, {overlap:.3f} with ants "
                  f"overlapping; one pass by {rule[0]}, the whole step by {rule[1]}")
            checks_w[state] = {**hold_capcap(name, state, env_.sys, qp, act, gen,
                                             f"composer {name} {state} "),
                               "contact_share": share, "capcap_share": overlap}
        w_checks[name] = checks_w

    phase("composer: main paths")
    mains = {scene: composer_main_path(tag, scene) for scene in COMPOSER_SCENES}

    phase("composer: pbd_step timings")
    scenes = {scene: scene_timings(tag, f"composer {scene}", composer_env(scene, N_ENVS, device))
              for scene in COMPOSER_TIMED}
    return {"checks": w_checks, "main": mains, "scene": scenes}


def scene_timings(tag, label, env_):
    """The PBD kernel for a bare env's System at PBD_TIMING_ENVS envs from
    COMPOSER_SETTLE twin steps after a reset (pbd_timings), its bound at
    N_ENVS (pbd_bound), its plain twin's time and its launch.  Returns the
    record."""
    device = DEVICE
    sys_ = env_.sys
    gen_t = torch.Generator(device=device).manual_seed(3)
    qp = env_.reset(gen_t).qp
    for _ in range(COMPOSER_SETTLE):
        qp, _ = kernels.pbd_step_plain(sys_, qp, torch.rand(
            (N_ENVS, env_.action_size), generator=gen_t, device=device) * 2 - 1)
    act = torch.rand((N_ENVS, env_.action_size), generator=gen_t, device=device) * 2 - 1
    b = pbd_bound(sys_, qp, act)
    r = {"bound": dict(zip(("bound_ms", "bound_by", "ops", "bytes"), b[:4])),
         "launch": pbd_launch_report(sys_, PBD_TIMING_ENVS, label)}
    r["plain_ms"] = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=1, warmup=1)
    r["ms_by_envs"] = pbd_timings(tag, sys_, qp, act, b[0] / N_ENVS, label)
    print(f"bound {tag}: pbd_step {label} at {N_ENVS} envs ({COMPOSER_SETTLE} twin steps "
          f"after a reset): {b[3]} bytes -> {b[4]:.5f} ms at 3.35 TB/s; {b[2]} fp32 ops (the "
          f"twin's, counted) -> {b[5]:.5f} ms at 67 TFLOP/s; plain twin "
          f"{r['plain_ms']:.3f} ms/step")
    return r


def biggym_paths(tag, phase, bg_envs):
    """The biggym phases: each new System (BIGGYM_SCENES, `bg_envs` their
    bare envs at N_ENVS) against the twin from pbd_parity.biggym_states
    over one pass and the whole step, by pbd_parity.RULES; env.step of
    every registry scene through biggym.create (composer_main_path: one
    launch a step, finite observations, a (N, 2) reward on the two-agent
    and match scenes); the kernel's timings, bound and plain version per
    new System (scene_timings)."""
    device = DEVICE
    phase("biggym: pbd_step parity")
    gen = torch.Generator(device=device).manual_seed(7)
    checks = {}
    for scene in BIGGYM_SCENES:
        env_ = bg_envs[scene]
        per = {}
        for state, (qp, act) in biggym_states(env_, N_ENVS, 0, device).items():
            share = contact_share(env_.sys, qp, act)
            rule = RULES[scene][state]
            print(f"parity state: biggym {scene}, {N_ENVS} envs, {state}, action "
                  f"{tuple(act.shape)}, {share:.3f} in contact; one pass by {rule[0]}, the whole "
                  f"step by {rule[1]}")
            per[state] = {**hold_capcap(scene, state, env_.sys, qp, act, gen,
                                        f"biggym {scene} {state} "), "contact_share": share}
        checks[scene] = per

    phase("biggym: main paths")
    biggym = biggym_registry()
    mains = {}
    for scene in biggym.ENVS:
        rec = mains[scene] = composer_main_path(
            tag, scene, env=biggym.create(scene, batch_size=N_ENVS, device=device),
            label="biggym", profiled=BIGGYM_PROFILED)
        two = scene.startswith(("match_", "chase_", "sumo_"))
        if rec["agents"] != (2 if two else 0):
            raise AssertionError(f"biggym {scene}: {rec['agents']} agents")

    phase("biggym: pbd_step timings")
    scenes = {scene: scene_timings(tag, f"biggym {scene}", bg_envs[scene])
              for scene in BIGGYM_SCENES}
    return {"checks": checks, "main": mains, "scene": scenes}


def population_paths(tag, phase):
    """ES and ARS on v1 ant at their trainers' defaults (ES: population
    128, 256 envs; ARS: 60 directions, 120 envs, top 20; episodes of
    1000 steps): two epochs (num_timesteps one more than an epoch's env
    steps: every ant lives its 1000 steps, so the second epoch ends the
    run) and one eval of PPO_EVAL_ENVS envs each, exactly (epochs + 1) x
    1000 PBD launches and no fused MLP launch, finite scores, the params
    moved; env-steps/s; then one epoch of POP_PROFILE_EPISODE-step episodes
    and its eval profiled (the device's kernels only), its device time per
    env step and busy share."""
    out = {}
    for label, trainer, kw, n_envs in (
            ("ES", es, {"population_size": 128}, 256),
            ("ARS", ars, {"number_of_directions": 60, "top_directions": 20}, 120)):
        phase(f"main path: {label} on v1 ant")
        run = dict(episode_length=POP_EPISODE, num_eval_envs=PPO_EVAL_ENVS, seed=0,
                   device=DEVICE, **kw)
        epochs, initial = [], {}
        real_episode = trainer.run_episode

        def counting(*args, **kwargs):
            epochs.append(1)
            return real_episode(*args, **kwargs)

        if trainer is es:
            def factory(*args, **kwargs):
                nets = es_networks.make_es_networks(*args, **kwargs)
                init = nets.policy_network.init
                nets.policy_network.init = lambda gen: initial.update(
                    {k: v.detach().clone() for k, v in init(gen).items()}) or dict(
                    nets.policy_network.mlp.named_parameters())
                return nets

            run["network_factory"] = factory
        trainer.run_episode = counting
        try:
            (make_policy, params, metrics), launches, seconds = counted(lambda: trainer.train(
                "ant", num_timesteps=n_envs * POP_EPISODE + 1, **run))
        finally:
            trainer.run_episode = real_episode
        want = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0, "pbd_step": (len(epochs) + 1) * POP_EPISODE}
        if len(epochs) != 2 or launches != want:
            raise AssertionError(f"{label}: {len(epochs)} epochs, launches {launches}, expected "
                                 f"{want}")
        for key in ("training/eval_scores_mean", "training/eval_scores_std",
                    "training/params_norm", "eval/episode_reward"):
            if not np.isfinite(metrics[key]):
                raise AssertionError(f"{label} {key} = {metrics[key]}")
        if trainer is es:
            moved = moved_from(initial, params[1], label)
            moved_text = f"every parameter moved (smallest max change {moved:.3e})"
        else:
            moved = float(params[1].abs().max())
            if not moved > 0:
                raise AssertionError("ARS: W did not move from zero")
            moved_text = f"W moved from zero (largest entry {moved:.3e})"
        print(f"main path {label} v1 ant: 2 epochs of {n_envs} envs x {POP_EPISODE} steps + one "
              f"eval of {PPO_EVAL_ENVS} envs in {seconds:.1f} s; launches {launches} (as "
              f"expected); eval_scores_mean {metrics['training/eval_scores_mean']:.5g}, "
              f"eval/episode_reward {metrics['eval/episode_reward']:.5g}; {moved_text}")
        print(f"timing {tag}: {label} v1 ant epoch 2: {metrics['training/sps']:.1f} env-steps/s "
              f"(host clock; rollout {metrics['training/rollout_s']:.3f} s, update "
              f"{metrics['training/update_s']:.4f} s); eval {metrics['eval/sps']:.1f} env-steps/s")
        from torch.profiler import ProfilerActivity, profile

        run.pop("network_factory", None)
        run["episode_length"] = POP_PROFILE_EPISODE
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train("ant", num_timesteps=1, **run)
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        device_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        steps = 2 * POP_PROFILE_EPISODE
        dev_us = sum(device_us(e) for e in events)
        pbd_us = sum(device_us(e) for e in events if "pbd_step" in e.key)
        prof_rec = {"device_us_per_step": dev_us / steps, "pbd_step_us_per_step": pbd_us / steps,
                    "kernels_per_step": sum(e.count for e in events) / steps,
                    "wall_s": wall_s, "busy_share": dev_us / (wall_s * 1e6) if dev_us else None}
        busy = f"{prof_rec['busy_share']:.3f}" if dev_us else "not measured (no device time)"
        print(f"profile {tag}: {label} v1 ant, one epoch of {POP_PROFILE_EPISODE}-step episodes "
              f"and its eval ({steps} env steps, the device's kernels only): "
              f"{prof_rec['device_us_per_step']:.1f} us device time a step "
              f"({prof_rec['pbd_step_us_per_step']:.1f} of it pbd_step), "
              f"{prof_rec['kernels_per_step']:.1f} kernels a step, {wall_s:.2f} s wall, busy "
              f"{busy}")
        for e in sorted(events, key=lambda e: -device_us(e))[:6]:
            print(f"  {device_us(e) / steps:9.1f} us/step  {e.count / steps:6.2f}/step  "
                  f"{e.key[:90]}")
        out[label] = {"launches": launches, "epochs": len(epochs), "seconds": seconds,
                      "env_steps_per_s": metrics["training/sps"], "metrics": metrics,
                      "moved": moved, "profile": prof_rec, "envs": n_envs}
    return out


def mappo_chase(batch_size, device):
    """The bare 2-agent ant chase: the factory MAPPO trains on."""
    return composer_envs.create_ma_env(task="chase", episode_length=None, batch_size=batch_size,
                                       auto_reset=False, device=device).unwrapped


def diayn_disc():
    """DIAYN's skill discriminator on v1 ant: q(z | the root's x and y
    velocity) an MLP, a categorical prior over 2 skills
    (braxlines.obs_indices' "vel" indices of ant)."""
    idx, scale = bl_obs_indices.get_indices("ant")
    return bl_discriminators.SkillDiscriminator(obs_indices=idx, obs_scale=scale, z_size=2,
                                                q_fn="mlp", dist_q="categorical",
                                                dist_p="categorical", device=DEVICE)


def trainer_launches(p, steps, agents=1, extra_fwd=0, extra_bwd=0):
    """(fwd, bwd, pbd_step) launches of `steps` training steps and one
    evaluation of PPO's recipe `p` (expected_launches) with a policy and a
    value chain per agent, and `extra_fwd` / `extra_bwd` more per training
    step (DIAYN's discriminator: its loss's forward and backward, the
    relabel's forward)."""
    fwd, bwd, pbd = expected_launches(p, steps)
    return (agents * fwd + steps * extra_fwd, agents * bwd + steps * extra_bwd, pbd)


def counted(run):
    """run() with every count set to 0 just before; (its result, the
    launches of the three kernels, seconds)."""
    kernels.pbd_step_launch.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                 "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                 "pbd_step": kernels.pbd_step_launch.launches}, seconds


def moved_from(initial, now, label):
    """The smallest max change of a parameter from `initial` to `now` (name
    -> tensor); raises where one did not change."""
    moved = {k: float((now[k].detach() - v).abs().max()) for k, v in initial.items()}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"{label}: parameters that did not change: "
                             f"{[k for k, v in moved.items() if not v > 0]}")
    return min(moved.values())


def trainer_paths(tag, phase, checks):
    """MAPPO on the 2-agent ant chase and DIAYN on v1 ant at the ant recipe's
    batch settings: MAPPO_STEPS / DIAYN_STEPS training steps and one eval of
    PPO_EVAL_ENVS envs each, with exact launch counts; their new fused
    chain shapes (the chase's 164-wide observation, ant's 89 with z, the
    discriminator's 2 -> 32 -> 32 -> 2 over the whole batch) held against
    the plain versions in bf16 first (into `checks`)."""
    p = recipe("ant")
    n_rows = p["batch_size"] * p["unroll_length"]
    batch_rows = p["batch_size"] * p["num_minibatches"] * p["unroll_length"]
    phase("MAPPO, DIAYN: fused_mlp parity at their shapes")
    shapes = [("policy_chase", p["num_envs"]), ("policy_chase", n_rows),
              ("value_chase", n_rows), ("value_chase", p["batch_size"]),
              ("policy_diayn", p["num_envs"]), ("policy_diayn", n_rows),
              ("value_diayn", n_rows), ("disc_diayn", batch_rows)]
    for name, rows in shapes:
        checks[name, rows, "bf16"] = c = check_chain(name, rows, True)
        print(f"parity fused_mlp {name}@{rows} bf16: " + ", ".join(
            f"{kind} max|kernel - plain| {r['max_abs_err']:.3e} ({r['fraction_of_tolerance']:.3f} "
            f"of the tolerance)" for kind, r in c.items()))
    disc_times = time_chain("disc_diayn", batch_rows, True)
    print(f"timing {tag}: fused_mlp disc_diayn@{batch_rows} bf16: fwd {disc_times['fwd']:.4f} ms, "
          f"bwd {disc_times['bwd']:.4f} ms graph-replayed; cuBLAS chain fwd "
          f"{disc_times['cublas_fwd']:.4f}, bwd {disc_times['cublas_bwd']:.4f}")

    phase("main path: MAPPO on the 2-agent ant chase")
    q = dict(p, num_timesteps=MAPPO_STEPS * env_steps_per_training_step(p), num_evals=1)
    want = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                    trainer_launches(q, MAPPO_STEPS, agents=2)))
    rollout, sgd, _ = launch_plan(q)
    # per agent a policy chain per env step, and a policy, a value and a
    # bootstrap-value chain forward and a policy and a value chain backward
    # per minibatch
    per_step = {"pbd_step": rollout * q["action_repeat"], "fused_mlp_fwd": 2 * (rollout + 3 * sgd),
                "fused_mlp_bwd": 2 * 2 * sgd}
    if per_step != {"pbd_step": 80, "fused_mlp_fwd": 928, "fused_mlp_bwd": 512}:
        raise AssertionError(f"MAPPO's launches per training step {per_step}")
    initial = []
    real_init = mappo._agent_params

    def recording(*args):
        params = real_init(*args)
        initial.append({f"{side}.{k}": v.detach().clone() for side, named in
                        (("policy", params.policy), ("value", params.value))
                        for k, v in named.items()})
        return params

    mappo._agent_params = recording
    try:
        (make_policy, params, m_metrics), m_launches, m_s = counted(lambda: mappo.train(
            mappo_chase, num_eval_envs=PPO_EVAL_ENVS, seed=0, device=DEVICE, **q))
    finally:
        mappo._agent_params = real_init
    if m_launches != want:
        raise AssertionError(f"MAPPO launches {m_launches}, expected {want}")
    for key in ("training/total_loss", "training/agent0/policy_loss", "training/agent1/v_loss",
                "eval/episode_reward"):
        if not np.isfinite(m_metrics[key]):
            raise AssertionError(f"MAPPO {key} = {m_metrics[key]}")
    normalizer, agent_params = params
    m_moved = min(moved_from(init, {f"{side}.{k}": v for side in ("policy", "value")
                                    for k, v in getattr(agent_params[agent], side).items()},
                             f"MAPPO {agent}")
                  for init, agent in zip(initial, sorted(agent_params)))
    env_m = mappo_chase(8, DEVICE)
    with torch.no_grad():
        act, _ = make_policy(params, deterministic=True)(
            torch.zeros((8, env_m.observation_size), device=DEVICE), None)
    if tuple(act.shape) != (8, env_m.action_size) or env_m.action_size != 16:
        raise AssertionError(f"MAPPO's joint action {tuple(act.shape)}")
    print(f"main path MAPPO 2-agent ant chase: {MAPPO_STEPS} training steps at the ant recipe "
          f"(num_envs {q['num_envs']}, batch {q['batch_size']} x {q['num_minibatches']} "
          f"minibatches, unroll {q['unroll_length']}, {q['num_updates_per_batch']} updates) + "
          f"one eval of {PPO_EVAL_ENVS} envs in {m_s:.1f} s; launches {m_launches} (as "
          f"expected; per training step {per_step}); total_loss "
          f"{m_metrics['training/total_loss']:.5g}, eval/episode_reward "
          f"{m_metrics['eval/episode_reward']:.5g}; every parameter of both agents moved "
          f"(smallest max change {m_moved:.3e}); joint action {tuple(act.shape)}")
    print(f"timing {tag}: MAPPO 2-agent chase training env-steps/s over step 2 (host clock, "
          f"fused_mlp on): {m_metrics['training/sps_after_first']:.1f}")

    phase("main path: DIAYN on v1 ant")
    disc = diayn_disc()
    d_initial = {k: v.detach().clone()
                 for k, v in disc.init(bl_train._disc_generator(0, DEVICE)).items()}
    want_d = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                      trainer_launches(q, DIAYN_STEPS, extra_fwd=2, extra_bwd=1)))
    per_step_d = {"pbd_step": rollout * q["action_repeat"], "fused_mlp_fwd": rollout + 3 * sgd + 2,
                  "fused_mlp_bwd": 2 * sgd + 1}
    if per_step_d != {"pbd_step": 80, "fused_mlp_fwd": 466, "fused_mlp_bwd": 257}:
        raise AssertionError(f"DIAYN's launches per training step {per_step_d}")
    recorder = InitRecorder()
    (_, d_params, d_metrics), d_launches, d_s = counted(lambda: bl_train.train_vgcrl(
        "ant", disc, seed=0, device=DEVICE, num_eval_envs=PPO_EVAL_ENVS, use_fused_kernel=True,
        network_factory=recorder.factory, **q))
    d_moved = check_ppo_run("DIAYN", d_metrics, recorder, d_params[1], d_launches, want_d)
    disc_moved = moved_from(d_initial, d_params[2], "DIAYN discriminator")
    widths = (recorder.initial["policy"]["hidden_0.kernel"].shape[0],
              recorder.initial["policy"]["hidden_4.kernel"].shape[1])
    if widths != (89, 16):
        raise AssertionError(f"the DIAYN policy maps {widths[0]} inputs to {widths[1]}")
    print(f"main path DIAYN v1 ant: {DIAYN_STEPS} training steps at the ant recipe + one eval of "
          f"{PPO_EVAL_ENVS} envs in {d_s:.1f} s; launches {d_launches} (as expected; per "
          f"training step {per_step_d}: PPO's 80 / 464 / 256, the discriminator's loss forward "
          f"and backward and its relabel forward); total_loss "
          f"{d_metrics['training/total_loss']:.5g}, eval/episode_reward "
          f"{d_metrics['eval/episode_reward']:.5g}; every parameter moved (policy and value "
          f"{d_moved:.3e}, discriminator {disc_moved:.3e})")
    print(f"timing {tag}: DIAYN ant training env-steps/s over step 2 (host clock, fused_mlp on): "
          f"{d_metrics['training/sps_after_first']:.1f}")
    return {"mappo": {"launches": m_launches, "per_step": per_step, "seconds": m_s,
                      "metrics": m_metrics},
            "diayn": {"launches": d_launches, "per_step": per_step_d, "seconds": d_s,
                      "metrics": d_metrics},
            "disc_times": disc_times}


def chain_paths(tag, phase, gen_sys, gen_env):
    """The chain entry (`gen_kernels.build_tiled_chain_fn`) on the v2 ant at
    N_ENVS: from 10 env steps after a reset, 3 chained steps against 3
    chained gen_step calls and gen_step_plain calls, bit for bit; the main
    path, CHAIN_STEPS chained steps with exactly one launch each (counts
    set to 0 just before, read just after); ms per launch graph-replayed
    and host-issued against gen_bound; then env-steps/s of the chain
    (host-issued and graph-replayed) and of env.step in turns
    (brax_torch.tools.bench_v2_generalized.measure)."""
    device = DEVICE
    phase("v2 chain: parity")
    bare = gen_env.unwrapped
    n_frames = bare._n_frames
    state = gen_env.reset(torch.Generator(device=device).manual_seed(4))
    act_gen = torch.Generator(device=device).manual_seed(5)
    act = lambda: torch.rand((N_ENVS, 8), generator=act_gen, device=device) * 2 - 1
    for _ in range(10):
        state = gen_env.step(state, act())
    ps = state.pipeline_state
    soa = lambda x: x.reshape(N_ENVS, -1).t().contiguous()
    step_t, schema = gen_kernels.build_tiled_chain_fn(gen_sys, n_frames, N_ENVS)
    carry = (soa(ps.q), soa(ps.qd), soa(ps.mass_mx_inv))
    chained = [ps.q, ps.qd, ps.mass_mx_inv]
    plain = list(chained)
    acts = [act() for _ in range(3)]
    identical = {}
    for i, a in enumerate(acts):
        carry, outs = step_t(carry, soa(a))
        out = gen_kernels.gen_step(gen_sys, *chained, a, n_frames)
        ref = gen_kernels.gen_step_plain(gen_sys, *plain, a, n_frames)
        chained = [out["q"], out["qd"], out["minv"]]
        plain = [ref["q"], ref["qd"], ref["minv"]]
        for k in out:
            identical[f"step {i + 1} {k} vs gen_step"] = bool(torch.equal(outs[k], soa(out[k])))
            identical[f"step {i + 1} {k} vs gen_step_plain"] = bool(
                torch.equal(outs[k], soa(ref[k])))
    print(f"parity chain: 3 chained steps of {n_frames} frames at {N_ENVS} envs, every output "
          f"bit for bit: {sum(identical.values())}/{len(identical)} identical")
    if not all(identical.values()):
        raise AssertionError(f"the chain differs from chained gen_step / gen_step_plain: "
                             f"{[k for k, v in identical.items() if not v]}")

    phase("main path: v2 chain")
    # the JAX tool's rollout: from a reset, zero actions, no reset on the
    # way.  The generalized step itself blows up in a few envs there (17 of
    # 4096 by step 50, from step 35; in gen_step, gen_step_plain and
    # env.step alike, PERF.md), so the chain is held to chained gen_step
    # calls bit for bit with NaN where they have NaN
    ps0 = gen_env.reset(torch.Generator(device=device).manual_seed(6)).pipeline_state
    zero = torch.zeros((N_ENVS, 8), device=device)
    carry0 = (soa(ps0.q), soa(ps0.qd), soa(ps0.mass_mx_inv))
    act_t = soa(zero)
    gen_kernels.gen_step_soa.launches = 0
    c = carry0
    for _ in range(CHAIN_STEPS):
        c, outs = step_t(c, act_t)
    torch.cuda.synchronize()
    chain_launches = gen_kernels.gen_step_soa.launches
    if chain_launches != CHAIN_STEPS:
        raise AssertionError(f"{CHAIN_STEPS} chain steps made {chain_launches} launches")
    # the same rollout through gen_step: the same bits
    s_ = [ps0.q, ps0.qd, ps0.mass_mx_inv]
    for _ in range(CHAIN_STEPS):
        out = gen_kernels.gen_step(gen_sys, *s_, zero, n_frames)
        s_ = [out["q"], out["qd"], out["minv"]]
    same = all(bool(((x == soa(y)) | (torch.isnan(x) & torch.isnan(soa(y)))).all())
               for x, y in zip(c, s_))
    nonfinite = int((~torch.cat([torch.isfinite(x) for x in c]).all(dim=0)).sum())
    print(f"main path v2 chain: {CHAIN_STEPS} chained steps from a reset, zero actions, "
          f"{chain_launches} gen_step launches; bit for bit those of {CHAIN_STEPS} chained "
          f"gen_step calls (NaN where they have NaN): {same}; envs with a non-finite carry: "
          f"{nonfinite} of {N_ENVS}")
    if not same or nonfinite > N_ENVS // 100:
        raise AssertionError(f"the chain's rollout: same bits as gen_step {same}, {nonfinite} "
                             f"non-finite envs")

    phase("v2 chain: timings and turns")
    ms_graph = probe.graph_us(lambda i: step_t(carry0, act_t), GRAPH_CALLS) / 1e3
    ms_host = probe.host_us(lambda i: step_t(carry0, act_t), GRAPH_CALLS) / 1e3
    ins = (ps.q, ps.qd, ps.mass_mx_inv, acts[0])
    b = gen_bound(gen_sys, ins, n_frames)
    plain_ms = cuda_ms(lambda: gen_kernels.gen_step_plain(gen_sys, *ins, n_frames), 1, 1)
    print(f"timing {tag}: chain step (gen_step_soa, {n_frames} frames, {N_ENVS} envs) "
          f"{ms_graph:.4f} ms graph-replayed, {ms_host:.4f} ms host-issued; plain "
          f"{plain_ms:.3f} ms; bound {b[0]:.5f} ms by {b[1]}")
    turns = bench_v2.measure("ant", N_ENVS, CHAIN_STEPS)
    for kind, rates in turns["env_steps_per_s"].items():
        print(f"timing {tag}: v2 ant {kind}: {', '.join(f'{x:,.0f}' for x in rates)} "
              f"env-steps/s ({N_ENVS} envs, {CHAIN_STEPS} steps, in turns)")
    print(f"parity chain vs pipeline.step, one frame from a reset: {turns['one_frame_parity']}")
    return {"identical": identical, "launches": chain_launches, "rollout_same_bits": same,
            "rollout_nonfinite_envs": nonfinite, "ms": ms_graph,
            "ms_host_issued": ms_host, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "ops": b[2], "bytes": b[3], "turns": turns, "schema": [k for k, _ in schema]}


def wide_entry(co, tr, bg, name_limit):
    """The kernels line's record of the PBD kernel's wide route (PBD_WIDE):
    its launches on the wide scenes' main paths (the composer's and
    biggym's) and MAPPO's, its parity checks, and its timings per wide
    System (the 2-agent chase's at the top level; octopus_run's, PBD_WIDE
    with PBD_SPRING, and biggym's new wide Systems under by_scene)."""
    main = {s: r for s, r in co["main"].items() if r["wide"]}
    bg_main = {s: r for s, r in bg["main"].items() if r["wide"]}
    bg_wide = [s for s in bg["scene"] if bg["main"][s]["wide"]]
    chase = co["scene"]["chase"]
    errs = [e for checks in (*co["checks"].values(), *(bg["checks"][s] for s in bg_wide))
            for ck in checks.values()
            for part in (ck, ck["one_pass"]) if part["rule"] == "max_errors"
            for e in part["max_abs_err_by_field"].values()]
    return {
        "name": "pbd_step_wide",
        "route": "cuda",
        "source": "brax_torch/csrc/pbd_step.cu",
        "replaces": "brax_tpu/sim/kernels.py:1283",
        "replaces_function": "brax_tpu/sim/kernels.py::_build_tile_step, on scenes wider than "
                             "a warp",
        "design": "PBD_WIDE: one env a block of 64-256 threads, its lanes exchanging through "
                  "shared memory (a barrier, a write, a barrier, a read)",
        "launches": sum(r["launches"] for r in (*main.values(), *bg_main.values()))
        + tr["mappo"]["launches"]["pbd_step"],
        "launches_by_path": {**{f"composer {s} env.step": r["launches"] for s, r in main.items()},
                             "MAPPO 2-agent chase": tr["mappo"]["launches"]["pbd_step"],
                             **{f"biggym {s} env.step": r["launches"]
                                for s, r in bg_main.items()}},
        "max_abs_err": max(errs),
        "max_abs_err_scope": "every env of every check held by max_errors (rounding-decided "
                             "outliers included); the chaotic checks (chaos_rule) under checks",
        "rules": {name: RULES[name] for name in (*COMPOSER_HELD, *BIGGYM_SCENES)},
        "tolerance": TOLERANCE,
        "checks": {**co["checks"], **{f"biggym {s}": bg["checks"][s] for s in bg_wide}},
        "ms": chase["ms_by_envs"][N_ENVS]["graph"],
        "ms_host_issued": chase["ms_by_envs"][N_ENVS]["host"],
        "plain_ms": chase["plain_ms"],
        "bound_ms": chase["bound"]["bound_ms"],
        "bound_by": chase["bound"]["bound_by"],
        "library_ms": None,
        "shape": f"the 2-agent chase at {N_ENVS} envs (64 lanes an env); by_scene: sumo, "
                 f"the 4-agent chase and octopus_run (legacy spring)",
        "by_scene": {label: {"ms": r["ms_by_envs"][N_ENVS]["graph"],
                             "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                             "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"],
                             **r["bound"], "launch": r["launch"]}
                     for label, r in (*((s, co["scene"][s])
                                        for s in ("chase", "sumo", "chase4", OCTOPUS)),
                                      *((f"biggym {s}", bg["scene"][s]) for s in bg_wide))},
        "card": name_limit,
    }


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
    comp_sys = {scene: composer_env(scene, N_ENVS, device).sys for scene in COMPOSER_SCENES}
    bg_registry = biggym_registry()
    bg_envs = {scene: biggym_env(scene, N_ENVS, device) for scene in bg_registry.ENVS}
    # the distinct Systems of the registry's scenes (each predator match is
    # a prey match mirrored, three scenes are earlier scenes' Systems)
    bg_sources = {}
    for scene, e in bg_envs.items():
        bg_sources.setdefault(kernels.kernel_source(e.sys), []).append(scene)
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
                             *(kernels.kernel_source(s_) for s_ in comp_sys.values()),
                             *(kernels.kernel_source(one_pass(comp_sys[name]))
                               for name in COMPOSER_HELD),
                             *bg_sources,
                             *(kernels.kernel_source(one_pass(bg_envs[scene].sys))
                               for scene in BIGGYM_SCENES),
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
    for scene in COMPOSER_TIMED:
        print(f"composer {scene}: " + " ".join(
            line.strip() for line in kernels.ptxas_report(comp_sys[scene]).splitlines()
            if "registers" in line or "spill" in line))
    for src, names in bg_sources.items():
        s_ = bg_envs[names[0]].sys
        print(f"biggym {', '.join(names)} ({src.name}; {s_.num_bodies} bodies, "
              f"{kernels.plan(s_).nc} contact points): " + " ".join(
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
    bg_launch = {", ".join(names): pbd_launch_report(bg_envs[names[0]].sys, PBD_TIMING_ENVS,
                                                     f"biggym {', '.join(names)}")
                 for names in bg_sources.values()}
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
    apg_states = {"ant": (sys_, qp, act)}

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
    for fused in PPO_TURNS:
        sps["on" if fused else "off"].append(
            run_ppo(fused, PPO_STEPS)[2]["training/sps_after_first"])
    print(f"timing {tag}: PPO training env-steps/s over steps 2-{PPO_STEPS} (host clock): "
          f"fused_mlp on {sps['on']}, off {sps['off']}")
    profiles = {"on": print_profile(tag, "", "on", profile_training_step(True, steps=1))}

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
    co = composer_paths(tag, phase)
    tr = trainer_paths(tag, phase, checks)
    bg = biggym_paths(tag, phase, bg_envs)
    pop = population_paths(tag, phase)

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
                                 "MAPPO 2-agent chase": tr["mappo"]["launches"][
                                     f"fused_mlp_{kind}"],
                                 "DIAYN v1 ant": tr["diayn"]["launches"][f"fused_mlp_{kind}"],
                                 **{f"APG {label} {k}": r["launches"][f"fused_mlp_{kind}"]
                                    for label in ("v1 ant", "v2 ant")
                                    for k, r in apg_run[label].items()},
                                 **{f"SAC {label}": r["launches"][f"fused_mlp_{kind}"]
                                    for label, r in sac_run["runs"].items()},
                                 "probe": probe_launches.get(f"fused_mlp_{kind}", 0)},
            "launches_per_training_step": per_step_launches[kind],
            "max_abs_err": max([c[kind]["max_abs_err"] for k, c in checks.items()
                                if k[2] == "bf16"]
                               + [c[mode][kind]["max_abs_err"]
                                  for c in sac_run["chains"]["checks"].values()
                                  for mode in ("relu_bf16", "swish_bf16") if kind in c[mode]]),
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
            "by_shape_sac": [
                {"chain": c, "dims": SAC_CHAINS[c], "rows": r, "mode": "bf16", "activation": "relu",
                 "ms": t[kind], "ms_host_issued": t[kind + "_host"],
                 "plain_ms": t["plain_" + kind], "cublas_chain_ms": t["cublas_" + kind],
                 "cublas_chain_ms_host_issued": t["cublas_" + kind + "_host"],
                 "bound_ms": sac_run["chains"]["bounds"][kind, c, r][0],
                 "bound_by": sac_run["chains"]["bounds"][kind, c, r][1],
                 "launch": sac_run["chains"]["plans"][kind, c, r],
                 "checks": {mode: e[kind] for mode, e in sac_run["chains"]["checks"][c, r].items()
                            if kind in e}}
                for (c, r), t in sac_run["chains"]["times"].items()
            ],
            "relu_rule": f"bf16 forward on every row; backward in f32 mode on the rows whose "
                         f"plain pre-activations lie further than {RELU_KINK} from 0, and in "
                         f"bf16 on every row with dx off on no more rows than bf16 and f32 flip "
                         f"at the kink and each dW and db within the plain bf16 version's own "
                         f"norm error against f32; bf16 forward and backward on every row with "
                         f"swish",
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

    # -- the chain entry on the v2 ant -------------------------------------------------
    ch = chain_paths(tag, phase, gen_sys, gen_env)

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
    for fused in PPO_TURNS:
        v2_sps["on" if fused else "off"].append(
            run_ppo(fused, PPO_STEPS, environment=v2_ant)[2]["training/sps_after_first"])
    print(f"timing {tag}: PPO on v2 ant, training env-steps/s over steps 2-{PPO_STEPS} (host "
          f"clock): fused_mlp on {v2_sps['on']}, off {v2_sps['off']}")
    v2_profiles = {"on": print_profile(tag, "PPO v2 ant, ", "on",
                                       profile_training_step(True, environment=v2_ant,
                                                             steps=1))}

    # -- APG: the physics Functions' gradients, then apg.train on v1 and v2 ant ----------
    apg_states.update({"grasp": tuple(g_scene["grasp"][k] for k in ("sys", "qp", "act")),
                       "fetch": tuple(b_scene["fetch"][k] for k in ("sys", "qp", "act")),
                       "spring ant": tuple(s_scene["ant"][k] for k in ("sys", "qp", "act"))})
    apg_run = apg_paths(tag, phase, apg_states, torch.Generator(device=device).manual_seed(11))

    # -- SAC: the fused kernels' Q route, then sac.train on humanoid, halfcheetah, v2 ant --------
    sac_run = sac_paths(tag, phase)

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
        **{label: {"env_steps_per_s_fused_on": r["metrics"]["training/sps_after_first"],
                   "eval_episode_reward": r["metrics"]["eval/episode_reward"],
                   "total_loss": r["metrics"]["training/total_loss"], "launches": r["launches"],
                   "launches_per_training_step": r["per_step"], "seconds": r["seconds"]}
           for label, r in (("mappo_chase", tr["mappo"]), ("diayn_ant", tr["diayn"]))},
        "spring_ant": {"env_steps_per_s_fused_on": sp_["ppo"]["training/sps_after_first"],
                       "eval_episode_reward": sp_["ppo"]["eval/episode_reward"],
                       "total_loss": sp_["ppo"]["training/total_loss"], "launches": s_launches,
                       "launches_per_training_step": sp_["per_step"],
                       "seconds": sp_["seconds"]},
        "card": name_limit}}))
    print(json.dumps({"apg": {
        "epoch_seconds": {f"{label} {kind}": {k: r[k] for k in ("rollout_s", "backward_s",
                                                               "update_s")}
                          for label in ("v1 ant", "v2 ant") for kind, r in apg_run[label].items()},
        "launches": {f"{label} {kind}": r["launches"] for label in ("v1 ant", "v2 ant")
                     for kind, r in apg_run[label].items()},
        "gradient_checks": {"pbd_step": apg_run["pbd_step_gradients"],
                            "gen_step": apg_run["gen_step_gradients"]},
        "max_memory_allocated": {f"{label} {kind}": r["max_memory_allocated"]
                                 for label in ("v1 ant", "v2 ant")
                                 for kind, r in apg_run[label].items()},
        "main_paths": {label: apg_run[label] for label in ("v1 ant", "v2 ant")},
        "card": name_limit}}))
    print(json.dumps({"sac": {
        "runs": sac_run["runs"],
        "fused_checks": {f"{c}@{r}": v for (c, r), v in sac_run["chains"]["checks"].items()},
        "card": name_limit}}))
    print(json.dumps({"biggym_es_ars": {
        "biggym_main_paths": bg["main"],
        "biggym_systems": {", ".join(names): src.name for src, names in bg_sources.items()},
        "biggym_launch": bg_launch,
        **{label: {k: r[k] for k in ("launches", "epochs", "seconds", "env_steps_per_s",
                                     "moved", "profile", "envs")}
           | {"eval_episode_reward": r["metrics"]["eval/episode_reward"],
              "eval_scores_mean": r["metrics"]["training/eval_scores_mean"],
              "rollout_s": r["metrics"]["training/rollout_s"],
              "update_s": r["metrics"]["training/update_s"]}
           for label, r in pop.items()},
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
            *g["twister"]["max_abs_err_by_field"].values()] + [
            e for scene, per in bg["checks"].items() if not bg["main"][scene]["wide"]
            for ck in per.values() for part in (ck, ck["one_pass"])
            if part["rule"] == "max_errors" for e in part["max_abs_err_by_field"].values()]),
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
        "backward": "kernels.PBDStep (torch.autograd.Function): the kernel forward, the twin "
                    "(pbd_step_plain) re-run under autograd from the saved inputs as the "
                    "backward, as the JAX package's _with_vjp (brax_tpu/sim/kernels.py:1357)",
        "backward_checks": apg_run["pbd_step_gradients"],
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
                             "PPO spring ant": s_launches["pbd_step"],
                             **{f"composer {scene} env.step": r["launches"]
                                for scene, r in co["main"].items()},
                             "MAPPO 2-agent chase (wide)": tr["mappo"]["launches"]["pbd_step"],
                             "DIAYN v1 ant": tr["diayn"]["launches"]["pbd_step"],
                             **{f"biggym {scene} env.step": r["launches"]
                                for scene, r in bg["main"].items() if not r["wide"]},
                             **{f"{label} v1 ant": r["launches"]["pbd_step"]
                                for label, r in pop.items()},
                             **{f"APG v1 ant {kind}": r["launches"]["pbd_step"]
                                for kind, r in apg_run["v1 ant"].items()},
                             **{f"SAC {label}": r["launches"]["physics"]
                                for label, r in sac_run["runs"].items()
                                if not label.startswith("v2")}},
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
            **{f"composer {scene}": {
                "ms": r["ms_by_envs"][N_ENVS]["graph"],
                "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                "launch": r["launch"], "main_path": co["main"][scene],
                **({"checks": co["checks"][scene]} if scene in co["checks"] else {})}
               for scene, r in co["scene"].items()},
            **{f"biggym {scene}": {
                "ms": r["ms_by_envs"][N_ENVS]["graph"],
                "ms_host_issued": r["ms_by_envs"][N_ENVS]["host"],
                "ms_by_envs": r["ms_by_envs"], "plain_ms": r["plain_ms"], **r["bound"],
                "launch": r["launch"], "main_path": bg["main"][scene],
                "checks": bg["checks"][scene]}
               for scene, r in bg["scene"].items() if not bg["main"][scene]["wide"]},
        },
        "card": name_limit,
    },
        wide_entry(co, tr, bg, name_limit),
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
            "backward": "generalized.kernels.GenStep (torch.autograd.Function): the kernel "
                        "forward, the VJP of GEN_FRAMES pipeline steps from the incoming State "
                        "as the backward, as the JAX package's _with_vjp "
                        "(brax_tpu/v2/generalized/kernels.py:1317)",
            "backward_checks": apg_run["gen_step_gradients"],
            "envs_per_block": gen_launches_by_scene["ant"][f"at_{N_ENVS}"]["envs_per_block"],
            "smem_bytes_per_env": gen_launches_by_scene["ant"]["smem_bytes_per_env"],
            "smem_bytes_per_block": gen_launches_by_scene["ant"][f"at_{N_ENVS}"][
                "smem_bytes_per_block"],
            "launch": gen_launches_by_scene["ant"],
            "ms_by_envs_and_envs_per_block": sweep,
            "launches_by_path": {"v2 ant env.step": gen_launches,
                                 "PPO v2 ant": v2_launches["gen_step"],
                                 **{f"APG v2 ant {kind}": r["launches"]["gen_step"]
                                    for kind, r in apg_run["v2 ant"].items()},
                                 "SAC v2 ant": sac_run["runs"]["v2 ant"]["launches"]["physics"],
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
            "name": "gen_step_chain",
            "route": "cuda",
            "source": "brax_torch/csrc/gen_step.cu",
            "replaces": "brax_tpu/v2/generalized/kernels.py:1181",
            "replaces_function": "brax_tpu/v2/generalized/kernels.py::build_tiled_chain_fn "
                                 "(its pallas_call, :1164)",
            "entry": "brax_torch.v2.generalized.kernels.build_tiled_chain_fn: one gen_step_soa "
                     "launch a step on the (fields, N) carry, no transposes",
            "launches": ch["launches"],
            "max_abs_err": 0.0 if all(ch["identical"].values()) else None,
            "tolerance": "bit for bit against chained gen_step and gen_step_plain",
            "bit_identical": ch["identical"],
            "ms": ch["ms"],
            "ms_host_issued": ch["ms_host_issued"],
            "plain_ms": ch["plain_ms"],
            "bound_ms": ch["bound_ms"],
            "bound_by": ch["bound_by"],
            "library_ms": None,
            "ops": ch["ops"],
            "bytes": ch["bytes"],
            "env_steps_per_s_in_turns": ch["turns"]["env_steps_per_s"],
            "one_frame_parity_vs_pipeline": ch["turns"]["one_frame_parity"],
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

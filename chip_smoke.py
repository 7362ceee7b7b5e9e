"""Smoke test of the brax_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds brax_torch/csrc/pbd_step.cu with nvcc (sm_90a) and prints ptxas's
   register and spill report;
3. holds the kernel against its plain-torch twin at the main path's shapes:
   ant at 4096 envs, from a contact-rich state (10 twin steps after reset).
   Every output (pos, rot, vel, ang and the contact vel/ang impulses) is
   held to the tolerance.  At most MAX_OUTLIERS envs may fall outside it,
   and each only if the twin, fed its input with noise of a few float32
   ulps, reproduces the kernel's output there;
4. drives the main path: envs.create("ant", batch_size=4096), reset, 200
   env.step calls with random actions, and checks that the kernel ran once
   per step and that every observation is finite;
5. times the kernel, the twin and env.step;
6. holds the fused MLP kernels (brax_torch/csrc/fused_mlp.cu, forward and
   backward) against their plain versions at the PPO ant recipe's shapes,
   with v1 ant's 87-wide and v2 ant's 27-wide observation, in bf16 and f32
   modes;
7. drives PPO: ppo.train on ant with the published recipe
   (DEFAULT_PPO_PARAMS["ant"]) at full width for 3 training steps and one
   evaluation of 128 envs, and checks the exact launch counts of all three
   kernels, finite losses, changed parameters and a finite eval reward;
8. times the fused kernels, their plain versions and the same chains as
   F.linear calls (cuBLAS, a yardstick), PPO env-steps/s with the fused
   kernels on and off, and profiles one training step each way;
9. holds the generalized-step kernel (brax_torch/csrc/gen_step.cu, built
   for the v2 ant) against its plain version at 4096 envs from a state 10
   plain env steps after reset, at one frame and at ant's five, with the
   rounding rule of step 3 (at most GEN_MAX_OUTLIERS envs), and at five
   frames from a contact-rich reset (the torso lowered);
10. drives the v2 main path: brax_torch.v2.envs.create("ant",
   batch_size=4096), reset, 200 env.step calls, one kernel launch each;
11. times that kernel, its plain version and v2 env.step, profiles 20
   env.step calls, counts the plain version's operations for the bound,
   and times the kernel at 32, 64 and 128 threads per block at 4096 and
   16384 envs;
12. holds the generalized-step kernel of each other v2 env (inverted
   pendulum, inverted double pendulum, reacher, halfcheetah, hopper,
   walker2d) against its plain version at 4096 envs and the env's n_frames,
   from a reset and, for the three with floor contacts, from a reset with
   the torso lowered into contact, with the rule of step 9;
13. drives each of those envs' main path: brax_torch.v2.envs.create(name,
   batch_size=4096), reset, 50 env.step calls, one launch each, and times
   the step, the kernel and its plain version beside the kernel's bound;
14. drives PPO on the v2 ant: ppo.train with a factory of the bare v2 ant at
   the ant recipe for 3 training steps and one evaluation of 128 envs, with
   exact launch counts of gen_step and of the fused MLP kernels, then
   times PPO env-steps/s with the fused kernels on and off in turns and
   profiles one training step each way;
15. reads the launch-overhead probe's counts, set to 0 before step 3, to
   show that no env or PPO path ran its kernels; holds them
   (brax_torch/csrc/probe.cu) against their plain versions, then drives the
   probe (brax_torch.tools.probe_overhead.measure), which times every
   launch both issued by the host and replayed from a CUDA graph;
16. prints one JSON line listing every kernel and, last,
   {"ok": true, "device": {...}}.

The CUDA sources are built at the start, one nvcc each, in parallel (the
generalized step once per v2 scene).
It fails, printing no result, without a CUDA device.  Imports nothing of
JAX.
"""

import json
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
from brax_torch.training import fused_mlp
from brax_torch.training.agents.ppo import networks as ppo_networks
from brax_torch.training.agents.ppo import train as ppo
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

N_ENVS = 4096
MAIN_STEPS = 200
# the CPU parity tests' in-contact tolerances (tests/test_torch_step.py)
TOLERANCE = {"pos": 1e-4, "rot": 1e-4, "vel": 3e-3, "ang": 3e-3, "contact_vel": 3e-3,
             "contact_ang": 3e-3}
# an env outside TOLERANCE passes only if the twin, fed that env's input with
# relative noise of these sizes (about 1 and 8 float32 ulps), reproduces the
# kernel's output within TOLERANCE in at least one of PERTURBED_COPIES tries
ROUNDING_NOISE = (1e-7, 1e-6)
PERTURBED_COPIES = 64
# more outlier envs than this fails outright (runs of this script on an H100
# at the seeds below have shown 1 of 4096)
MAX_OUTLIERS = 4
# H100 SXM data sheet: HBM3 bandwidth, fp32 rate outside the tensor cores,
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the PPO ant recipe's MLP chains (make_ppo_networks' defaults, 8 actions):
# v1 ant's 87-wide observation, and v2 ant's 27-wide one ("_v2")
CHAINS = {"value": [87] + [256] * 5 + [1], "policy": [87] + [32] * 4 + [16],
          "value_v2": [27] + [256] * 5 + [1], "policy_v2": [27] + [32] * 4 + [16]}
# (chain, rows) as the PPO paths launch them: minibatch [T=5, 1024] losses
# (5120 rows), the rollout's policy at 2048 envs, the bootstrap value at 1024
CHAIN_SHAPES = [(c + v, r) for v in ("", "_v2")
                for c, r in (("value", 5120), ("policy", 5120), ("policy", 2048), ("value", 1024))]
# f32 mode: tests/test_fused_mlp.py's tolerances (|err| <= atol + rtol |plain|)
F32_TOL = {"fwd": (2e-5, 2e-5), "bwd": (2e-4, 2e-5)}
# bf16 mode: max |kernel - plain| <= BF16_REL * max |plain|, per output.  The
# two round the same values to bf16, but f32 sums taken in another order
# can round an activation to a neighbouring bf16 number
BF16_REL = 1e-2
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
# threads per block and batch sizes of the gen_step block-size sweep (one pass)
GEN_BLOCKS = (32, 64, 128)
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


def _fields(qp, info):
    return {"pos": qp.pos, "rot": qp.rot, "vel": qp.vel, "ang": qp.ang,
            "contact_vel": info.contact.vel, "contact_ang": info.contact.ang}


def _per_env_errors(a, b):
    """{field: (N,) max abs error per env} between two _fields dicts."""
    return {k: (a[k] - b[k]).abs().amax(dim=(1, 2)) for k in TOLERANCE}


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
    errs = _per_env_errors(_fields(pout, pinfo), want)
    ok = torch.stack([errs[f] <= TOLERANCE[f] for f in TOLERANCE]).all(dim=0)
    return ok.reshape(len(idx), k).any(dim=1)


def max_errors(sys_, qp, act, gen):
    """Kernel vs twin from one state.

    Returns ({field: max abs error over all envs}, {field: max abs error
    over the envs within TOLERANCE on every field}, outlier count).  Every
    field of every env must be within TOLERANCE, except in at most
    MAX_OUTLIERS envs, each of which must be one whose result float
    rounding decides (rounding_decided): the kernel
    computes in the order of the Pallas kernel it replaces, the twin in the
    order of the JAX jnp path, and near a contact threshold that order picks
    the branch.  scripts/replay_outliers.py replays such envs through both
    JAX paths, which split on them the same way.
    """
    out, info = kernels.pbd_step(sys_, qp, act)
    ref, info_ref = kernels.pbd_step_plain(sys_, qp, act)
    torch.cuda.synchronize()
    kernel_out = _fields(out, info)
    per_env = _per_env_errors(kernel_out, _fields(ref, info_ref))
    over = torch.stack([~(e <= TOLERANCE[k]) for k, e in per_env.items()]).any(dim=0)
    errs, inside_errs = {}, {}
    for k, e in per_env.items():
        errs[k] = float(e.max())
        inside_errs[k] = float(e[~over].max()) if bool((~over).any()) else float("nan")
        print(f"parity {k}: max|kernel - twin| = {errs[k]:.3e} over all envs, "
              f"{inside_errs[k]:.3e} over the {int((~over).sum())} envs within tolerance "
              f"(tolerance {TOLERANCE[k]:.0e}; this field within it in "
              f"{int((e <= TOLERANCE[k]).sum())}/{e.numel()} envs)")
    idx = over.nonzero().flatten()
    outliers = len(idx)
    print(f"parity: {outliers} outlier envs of {over.numel()}: {idx.tolist()}")
    if outliers > MAX_OUTLIERS:
        raise AssertionError(f"kernel disagrees with its plain twin in {outliers} envs "
                             f"(at most {MAX_OUTLIERS} allowed): {errs}")
    if outliers:
        # inputs and both outputs of the outliers, for scripts/replay_outliers.py
        path = kernels.BUILD_DIR / "parity_outliers.npz"
        host = lambda x: x[idx].cpu().numpy()
        np.savez(path, pos=host(qp.pos), rot=host(qp.rot), vel=host(qp.vel),
                 ang=host(qp.ang), act=host(act), kernel_vel=host(out.vel),
                 twin_vel=host(ref.vel), kernel_contact_ang=host(info.contact.ang),
                 twin_contact_ang=host(info_ref.contact.ang))
        print(f"parity: outlier inputs saved to {path}")
        decided = rounding_decided(sys_, qp, act, idx, kernel_out, gen)
        print(f"parity: the twin reproduces the kernel from input noise of relative size "
              f"{ROUNDING_NOISE} in {int(decided.sum())}/{outliers} outlier envs")
        if not bool(decided.all()):
            raise AssertionError(f"kernel disagrees with its plain twin in envs "
                                 f"{idx[~decided].tolist()}, beyond rounding: {errs}")
    return errs, inside_errs, outliers


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
    GEN_MULTI_FRAME_BOUNDS and raises if they exceed them."""
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
    return errs, inside_errs, outliers


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
    """ms per call of each kernel, its plain version, and the same chain as
    F.linear calls (cuBLAS) in the same precision; CUDA events."""
    dims, x, ws, bs, g = chain_inputs(name, rows)
    t = {
        "fwd": cuda_ms(lambda: fused_mlp.chain_fwd(x, ws, bs, "swish", bf16), 200, 20),
        "bwd": cuda_ms(lambda: fused_mlp.chain_bwd(x, ws, bs, g, "swish", bf16), 200, 20),
        "plain_fwd": cuda_ms(lambda: fused_mlp.chain_fwd_plain(x, ws, bs, "swish", bf16), 50, 5),
        "plain_bwd": cuda_ms(lambda: fused_mlp.chain_bwd_plain(x, ws, bs, g, "swish", bf16),
                             50, 5),
    }
    dt = torch.bfloat16 if bf16 else torch.float32
    wl = [w.t().contiguous().to(dt).requires_grad_() for w in ws]
    bl = [b.to(dt).requires_grad_() for b in bs]

    def linear_chain(h):
        for i, (w, b) in enumerate(zip(wl, bl)):
            h = F.linear(h, w, b)
            if i < len(wl) - 1:
                h = F.silu(h)
        return h

    with torch.no_grad():
        t["cublas_fwd"] = cuda_ms(lambda: linear_chain(x.to(dt)), 200, 20)
    xl = x.to(dt).requires_grad_()
    y = linear_chain(xl)
    gl = g.to(dt)
    t["cublas_bwd"] = cuda_ms(
        lambda: torch.autograd.grad(y, [xl, *wl, *bl], gl, retain_graph=True), 200, 20)
    return t


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def recipe():
    return dict(DEFAULT_PPO_PARAMS["ant"])


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


def run_ppo(fused, steps, environment="ant", **kw):
    p = recipe()
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


def profile_training_step(fused, environment="ant"):
    """Device time, device-op count and top kernels of the second of two
    training steps (the host range "ppo/training_step", which ends in a
    synchronise), and the host time of its rollout and SGD ranges.

    The episode is cut to PROFILE_EPISODE steps so that the run's one
    evaluation stays short; a training step does the same work at any
    episode length (auto-reset runs every step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_ppo(fused, steps=2, environment=environment, episode_length=PROFILE_EPISODE)
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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    start = time.perf_counter()
    phase = lambda label: print(f"[{time.perf_counter() - start:.1f} s] {label}", flush=True)
    name_limit = cuda_build.card()
    print(name_limit)
    tag = f"[{name_limit}]"

    # -- build: the three sources, one nvcc each, in parallel ---------------------
    t0 = time.perf_counter()
    gen_env = v2_envs.create("ant", episode_length=1000, batch_size=N_ENVS)
    gen_sys = gen_env.sys
    scenes = [gen_sys] + [v2_envs.get_environment(name).sys for name in V2_ENVS]
    built = cuda_build.build(kernels.SOURCE, fused_mlp.SOURCE, probe.SOURCE,
                             *(gen_kernels.kernel_source(s) for s in scenes))
    print(f"build: {', '.join(p.name for p in built.values())} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    print(kernels.ptxas_report().strip())
    print(fused_mlp.ptxas_report().strip())
    print(probe.ptxas_report().strip())
    for scene in scenes:
        print(gen_kernels.ptxas_report(scene).strip())

    # the probe runs on no env or PPO path: its counts, set to 0 here, are
    # read before its own phase
    probe.copy_plus_one.launches = probe.dot_chain.launches = 0

    # -- kernel against its plain twin at 4096 envs, in contact ---------------
    phase("pbd_step parity")
    env = envs.create("ant", episode_length=1000, auto_reset=True, batch_size=N_ENVS)
    sys_ = env.sys
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
    state = env.reset(torch.Generator(device=device).manual_seed(1))
    act_gen = torch.Generator(device=device).manual_seed(2)
    kernels.pbd_step_soa.launches = 0
    for i in range(MAIN_STEPS):
        if i == 20:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        act = torch.rand((N_ENVS, env.action_size), generator=act_gen, device=device) * 2 - 1
        state = env.step(state, act)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (MAIN_STEPS - 20)
    launches = kernels.pbd_step_soa.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"{MAIN_STEPS} env steps made {launches} kernel launches")
    if not bool(torch.isfinite(state.obs).all()):
        raise AssertionError("non-finite observations after the main path")
    if state.obs.shape != (N_ENVS, 87):
        raise AssertionError(f"obs shape {tuple(state.obs.shape)}")
    print(f"main path: {MAIN_STEPS} env.step calls, {launches} kernel launches, obs finite, "
          f"done fraction {float(state.done.mean()):.4f}")

    # -- timings ------------------------------------------------------------
    phase("pbd_step timings")
    soa = lambda x: x.permute(1, 2, 0).contiguous()
    ins = (soa(qp.pos), soa(qp.rot), soa(qp.vel), soa(qp.ang), act.t().contiguous())
    kernel_ms = cuda_ms(lambda: kernels.pbd_step_soa(sys_, *ins), reps=200, warmup=20)
    plain_ms = cuda_ms(lambda: kernels.pbd_step_plain(sys_, qp, act), reps=10, warmup=2)
    counter = OpCount()
    with counter:
        kernels.pbd_step_plain(sys_, qp, act)
    n_act = act.shape[1]
    nb = sys_.num_bodies
    ftab, itab = kernels.pack_tables(sys_)
    n_bytes = 4 * N_ENVS * (13 * nb + n_act + 19 * nb) + ftab.nbytes + itab.nbytes
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = counter.ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"timing {tag}: pbd_step kernel {kernel_ms:.4f} ms/launch at {N_ENVS} envs "
          f"(CUDA events, 200 launches)")
    print(f"timing {tag}: plain twin {plain_ms:.3f} ms/step at {N_ENVS} envs")
    print(f"timing {tag}: env.step {step_s * 1e3:.4f} ms/step, "
          f"{N_ENVS / step_s:.1f} env-steps/s (host clock, {MAIN_STEPS - 20} steps)")
    print(f"bound {tag}: {n_bytes} bytes -> {bytes_ms:.5f} ms at 3.35 TB/s; "
          f"{counter.ops} fp32 ops (the twin's, counted) -> {ops_ms:.5f} ms at 67 TFLOP/s")

    # -- where env.step's device time goes ---------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            act = torch.rand((N_ENVS, env.action_size), generator=act_gen, device=device) * 2 - 1
            state = env.step(state, act)
        torch.cuda.synchronize()
    device_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(device_us(e) for e in events)
    if total_us:
        n_kernels = sum(e.count for e in events) / 20
        print(f"profile {tag}: 20 env.step calls, {total_us / 20:.1f} us device time and "
              f"{n_kernels:.0f} kernels per step")
        for e in sorted(events, key=lambda e: -device_us(e))[:6]:
            print(f"  {device_us(e) / 20:9.1f} us/step  {e.count // 20:4d}/step  "
                  f"{e.key[:90]}")
    else:
        print("profile: no device time recorded (not measured)")

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

    # -- main path 2: PPO on ant, the published recipe at full width ---------------
    phase("main path: PPO")
    p = recipe()
    want = dict(zip(("fused_mlp_fwd", "fused_mlp_bwd", "pbd_step"),
                    expected_launches(p, PPO_STEPS)))
    recorder = InitRecorder()
    kernels.pbd_step_soa.launches = 0
    fused_mlp.chain_fwd.launches = fused_mlp.chain_bwd.launches = 0
    t0 = time.perf_counter()
    _, (_, policy_params), ppo_metrics = run_ppo(True, PPO_STEPS,
                                                 network_factory=recorder.factory)
    torch.cuda.synchronize()
    ppo_s = time.perf_counter() - t0
    ppo_launches = {"fused_mlp_fwd": fused_mlp.chain_fwd.launches,
                    "fused_mlp_bwd": fused_mlp.chain_bwd.launches,
                    "pbd_step": kernels.pbd_step_soa.launches}
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
                      f"{t[kind]:.4f} ms, plain {t['plain_' + kind]:.4f} ms, F.linear chain "
                      f"(cuBLAS) {t['cublas_' + kind]:.4f} ms; bound {b[0]:.5f} ms by {b[1]} "
                      f"({b[2]:.4g} ops, {b[3]} bytes)")
    # device ms per training step in each kernel, bf16 (the main path's mode)
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
                                 "probe": probe_launches.get(f"fused_mlp_{kind}", 0)},
            "launches_per_training_step": per_step_launches[kind],
            "max_abs_err": max(c[kind]["max_abs_err"] for k, c in checks.items()
                               if k[2] == "bf16"),
            "max_abs_err_f32": max(c[kind]["max_abs_err"] for k, c in checks.items()
                                   if k[2] == "f32"),
            "tolerance": {"bf16_rel_to_max": BF16_REL, "f32_rtol_atol": F32_TOL[kind]},
            "shape": "value chain 87-256x5-1 at 5120 rows, bf16; by_shape has every "
                     "chain of both PPO paths (87-wide v1 ant, 27-wide v2 ant)",
            "ms": times[main][kind],
            "plain_ms": times[main]["plain_" + kind],
            "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": None,
            "cublas_chain_ms": times[main]["cublas_" + kind],
            "ms_per_training_step": per_step[kind],
            "ms_per_training_step_v2": per_step_v2[kind],
            "by_shape": [
                {"chain": c, "rows": r, "mode": m, "ms": times[c, r, m][kind],
                 "plain_ms": times[c, r, m]["plain_" + kind],
                 "cublas_chain_ms": times[c, r, m]["cublas_" + kind],
                 "bound_ms": bounds[kind, c, r, m][0], "bound_by": bounds[kind, c, r, m][1],
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            act = torch.rand((N_ENVS, 8), generator=act_gen, device=device) * 2 - 1
            state = gen_env.step(state, act)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    gen_profile = {"device_us_per_step": sum(device_us(e) for e in events) / 20,
                   "kernels_per_step": sum(e.count for e in events) / 20}
    if gen_profile["device_us_per_step"]:
        print(f"profile {tag}: 20 v2 env.step calls, {gen_profile['device_us_per_step']:.1f} us "
              f"device time and {gen_profile['kernels_per_step']:.0f} kernels per step "
              f"(host {gen_step_s * 1e6:.1f} us per step)")
        for e in sorted(events, key=lambda e: -device_us(e))[:8]:
            print(f"  {device_us(e) / 20:9.1f} us/step  {e.count / 20:6.2f}/step  {e.key[:90]}")
    else:
        print("profile: v2 env.step: no device time recorded (not measured)")

    # -- gen_step block sizes: one pass --------------------------------------------
    phase("gen_step block sizes")
    sweep = {}
    for n_sweep in GEN_SWEEP_ENVS:
        sweep_ins = tuple(x.repeat(1, n_sweep // N_ENVS).contiguous() for x in gen_soa)
        sweep[n_sweep] = {block: cuda_ms(lambda: gen_kernels.gen_step_soa(
            gen_sys, *sweep_ins, GEN_FRAMES, block=block), 30, 3) for block in GEN_BLOCKS}
        print(f"timing {tag}: gen_step at {n_sweep} envs by threads per block (ms per "
              f"launch): {sweep[n_sweep]}")

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
        "card": name_limit}}))
    print(json.dumps({"kernels": [{
        "name": "pbd_step",
        "route": "cuda",
        "source": "brax_torch/csrc/pbd_step.cu",
        "replaces": "brax_tpu/sim/kernels.py:1283",
        "replaces_function": "brax_tpu/sim/kernels.py::_build_tile_step",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_field": errs,
        "max_abs_err_within_tolerance": max(inside_errs.values()),
        "max_abs_err_within_tolerance_by_field": inside_errs,
        "tolerance": TOLERANCE,
        "outlier_envs_decided_by_rounding": outliers,
        "max_outliers": MAX_OUTLIERS,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "env_steps_per_s": N_ENVS / step_s,
        "launches_ppo": ppo_launches["pbd_step"],
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
            "block": gen_kernels.BLOCK,
            "ms_by_envs_and_block": sweep,
            "launches_by_path": {"v2 ant env.step": gen_launches,
                                 "PPO v2 ant": v2_launches["gen_step"],
                                 **{f"v2 {name} env.step": r["launches"]
                                    for name, r in v2_records.items()}},
            "by_env": {name: {
                **record,
                "max_abs_err": max(max(c[0].values()) for c in v2_checks[name].values()),
                "max_abs_err_by_check": {k: c[0] for k, c in v2_checks[name].items()},
                "outlier_envs_decided_by_rounding": {k: c[2] for k, c in v2_checks[name].items()},
                "contact_share_lowered": v2_contact[name],
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

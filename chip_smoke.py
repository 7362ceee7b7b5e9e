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
5. times the kernel, the twin and env.step, and prints one JSON line per
   kernel and, last, {"ok": true, "device": {...}}.

It fails, printing no result, without a CUDA device.  Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from brax_torch import envs
from brax_torch.sim import kernels

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
# H100 SXM data sheet: HBM3 bandwidth and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


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
    REDUCE = {"sum", "any", "all", "linalg_vector_norm"}

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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    name_limit = card()
    print(name_limit)
    tag = f"[{name_limit}]"

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kernels.build()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    print(kernels.ptxas_report().strip())

    # -- kernel against its plain twin at 4096 envs, in contact ---------------
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
        "card": name_limit,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

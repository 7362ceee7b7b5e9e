"""Checks of the physics steps' autograd Functions (`kernels.PBDStep`, v1;
`generalized.kernels.GenStep`, v2), shared by `chip_smoke.py` and the
tests.

Each check takes the gradient of a fixed random linear functional of a
step's outputs, sum(w * out) over every output tensor (`weights`), so that
every output's cotangent enters the backward:

- `pbd_grads`: the gradients (pos, rot, vel, ang, act) through
  `kernels.pbd_step` with its inputs requiring grad (the Function: the
  kernel forward on CUDA tensors) or through `kernels.pbd_step_plain` (the
  twin under autograd), over `steps` steps with the action held;
- `gen_grads`: the gradients (act, then every float leaf of the State)
  through `generalized.kernels.kernel_step` (the Function) or through
  `n_frames` pipeline steps under autograd;
- `hold_rollout_grads`: the Function's gradients over several steps
  against the twin's, env by env, by the rules of
  `brax_torch.tools.pbd_parity`: the rounding rule (at most MAX_OUTLIERS
  envs outside GRAD_TOLERANCE, each one whose gradient the twin reaches
  from rounding-level input noise), else the chaos rule (each env within
  CHAOS_RATIO x the twin's own spread under CHAOS_NOISE, in all but
  CHAOS_SHARE of the envs): over several contact steps the two
  trajectories part by rounding, as the forward's do;
- `saved_tensors`: a call's result and how many tensors autograd saved
  while it ran;
- `deterministic`: deterministic kernels inside a block, for comparing two
  backwards on the card bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from brax_torch.sim import kernels
from brax_torch.sim.types import QP
from brax_torch.tools.pbd_parity import (CHAOS_COPIES, CHAOS_NOISE, CHAOS_RATIO, CHAOS_SHARE,
                                         MAX_OUTLIERS, PERTURBED_COPIES, ROUNDING_NOISE)
from brax_torch.v2.generalized import kernels as gen_kernels

Tensor = torch.Tensor
PBD_INPUTS = ("pos", "rot", "vel", "ang", "act")
# an env's gradient is within tolerance when every entry of each input's
# gradient is within this share of that input's largest |entry| over the
# batch (the CPU tests' bound against jax.grad, tests/apg_parity.py)
GRAD_TOLERANCE = 1e-3


def weights(outs: Sequence[Tensor], seed: int = 0) -> List[Tensor]:
    """Standard normal weights, one tensor per output, from `seed`."""
    gen = torch.Generator(device=outs[0].device).manual_seed(seed)
    return [torch.randn(o.shape, generator=gen, device=o.device) for o in outs]


def _functional(outs: Sequence[Tensor], ws: Sequence[Tensor]) -> Tensor:
    return sum(torch.sum(w * o) for w, o in zip(ws, outs))


def pbd_outputs(qp: QP, info) -> Tuple[Tensor, ...]:
    return qp.pos, qp.rot, qp.vel, qp.ang, info.contact.vel, info.contact.ang


def pbd_grads(sys_, qp: QP, act: Tensor, ws: Sequence[Tensor], step: Callable,
              steps: int = 1) -> Dict[str, Tensor]:
    """{input: gradient} of sum(w * out) over the outputs of the last of
    `steps` calls of `step` (`kernels.pbd_step` or `kernels.pbd_step_plain`)
    from (qp, act), the action held."""
    ins = [t.detach().clone().requires_grad_() for t in (qp.pos, qp.rot, qp.vel, qp.ang, act)]
    cur = QP(*ins[:4])
    for _ in range(steps):
        cur, info = step(sys_, cur, ins[4])
    grads = torch.autograd.grad(_functional(pbd_outputs(cur, info), ws), ins, allow_unused=True)
    return {k: torch.zeros_like(t) if g is None else g
            for k, t, g in zip(PBD_INPUTS, ins, grads)}


def gen_grads(sys_, state, act: Tensor, n_frames: int, ws: Sequence[Tensor],
              route: str) -> List[Tensor]:
    """Gradients of sum(w * leaf) over the float leaves of the State one
    env step on, w.r.t. the action and each float leaf of `state`: through
    the Function (`route` "function") or through `n_frames` pipeline steps
    under autograd ("pipeline").  An input the step does not read gets
    zeros."""
    from brax_torch.v2.generalized import pipeline as g_pipeline

    leaves = [t.detach().clone().requires_grad_() for t in gen_kernels.float_leaves(state)]
    a = act.detach().clone().requires_grad_()
    cur = gen_kernels.with_float_leaves(state, leaves)
    if route == "function":
        cur = gen_kernels.kernel_step(sys_, cur, a, n_frames)
    else:
        for _ in range(n_frames):
            cur = g_pipeline.step(sys_, cur, a)
    outs = gen_kernels.float_leaves(cur)
    grads = torch.autograd.grad(_functional(outs, ws), [a] + leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip([a] + leaves, grads)]


def bit_identical(a, b) -> bool:
    """Every tensor of two equal-length sequences (or dicts) equal, bit for bit."""
    if isinstance(a, dict):
        a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def saved_tensors(fn: Callable):
    """(fn(), the number of tensors autograd saved for a backward while
    fn ran)."""
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, count[0]


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels inside the block: the twin's and the
    pipeline's backwards on CUDA sum with atomics otherwise (index_add, the
    gathers' backward), so two backwards of one graph could differ in the
    last bits."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def _per_env_errors(got: Dict[str, Tensor], want: Dict[str, Tensor],
                    scale: Dict[str, Tensor]) -> Tensor:
    """(N,) the largest error of an env over the inputs, each input's
    relative to its `scale` (its largest |gradient entry| over the batch)."""
    errs = [(got[k] - want[k]).abs().flatten(1).amax(dim=1) / scale[k] for k in PBD_INPUTS]
    return torch.stack(errs).amax(dim=0)


def _noisy_rows(qp: QP, act: Tensor, idx: Tensor, copies: int, scales: Tensor,
                gen: torch.Generator):
    """Each env of `idx` repeated `copies` times, every state component
    scaled by (1 + s u), u uniform in [-1, 1], s the copy's scale."""
    def noisy(x):
        rep = x[idx].repeat_interleave(copies, dim=0)
        u = torch.rand(rep.shape, generator=gen, device=rep.device) * 2 - 1
        return rep * (1 + scales.repeat(len(idx)).reshape((-1,) + (1,) * (rep.dim() - 1)) * u)

    return (QP(*(noisy(x) for x in (qp.pos, qp.rot, qp.vel, qp.ang))),
            act[idx].repeat_interleave(copies, dim=0))


def hold_rollout_grads(sys_, qp: QP, act: Tensor, steps: int, gen: torch.Generator,
                       seed: int = 0) -> dict:
    """The Function's gradients over `steps` steps (the kernel forward on
    CUDA tensors) against the twin's under autograd, env by env: the
    rounding rule, else the chaos rule (see the module doc).  Raises where
    both fail; returns the record."""
    n = qp.pos.shape[0]
    ws = weights(pbd_outputs(*kernels.pbd_step_plain(sys_, qp, act)), seed)
    got = pbd_grads(sys_, qp, act, ws, kernels.pbd_step, steps)
    want = pbd_grads(sys_, qp, act, ws, kernels.pbd_step_plain, steps)
    scale = {k: want[k].abs().max().clamp(min=1e-30) for k in PBD_INPUTS}
    errs = _per_env_errors(got, want, scale)
    outside = (errs > GRAD_TOLERANCE).nonzero().flatten()
    record = {"steps": steps, "envs": n, "max_rel_err": float(errs.max()),
              "outside_tolerance": len(outside), "tolerance": GRAD_TOLERANCE}
    if len(outside) <= MAX_OUTLIERS:
        decided = torch.ones(0, dtype=torch.bool)
        if len(outside):
            k = PERTURBED_COPIES
            scales = torch.tensor(ROUNDING_NOISE, device=act.device).repeat(k // 2)
            pqp, pact = _noisy_rows(qp, act, outside, k, scales, gen)
            pws = [w[outside].repeat_interleave(k, dim=0) for w in ws]
            twin = pbd_grads(sys_, pqp, pact, pws, kernels.pbd_step_plain, steps)
            rel = _per_env_errors({f: got[f][outside].repeat_interleave(k, dim=0)
                                   for f in PBD_INPUTS}, twin, scale)
            decided = (rel <= GRAD_TOLERANCE).reshape(len(outside), k).any(dim=1)
        if bool(decided.all()):
            return {**record, "rule": "rounding", "outliers": outside.tolist()}
    spread_qp, spread_act = _noisy_rows(qp, act, torch.arange(n, device=act.device),
                                        CHAOS_COPIES, torch.full((CHAOS_COPIES,), CHAOS_NOISE,
                                                                 device=act.device), gen)
    copies = pbd_grads(sys_, spread_qp, spread_act,
                       [w.repeat_interleave(CHAOS_COPIES, dim=0) for w in ws],
                       kernels.pbd_step_plain, steps)
    repeated = {f: want[f].repeat_interleave(CHAOS_COPIES, dim=0) for f in PBD_INPUTS}
    spread = _per_env_errors(copies, repeated, scale).reshape(n, CHAOS_COPIES).amax(dim=1)
    strays = ((errs > GRAD_TOLERANCE) & (errs > CHAOS_RATIO * spread)).nonzero().flatten()
    allowed = int(CHAOS_SHARE * n)
    record.update(rule="chaos", strays=len(strays), allowed=allowed,
                  spread_outside=int((spread > GRAD_TOLERANCE).sum()))
    if len(strays) > allowed:
        raise AssertionError(f"the Function's gradients over {steps} steps stray from the "
                             f"twin's in {len(strays)} envs (at most {allowed}): {record}")
    return record

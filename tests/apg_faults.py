"""Faults planted in the physics steps' autograd Functions, each of which
the CPU tests of APG's gradients must fail
(tests/test_torch_apg_pbd_grad.py, tests/test_torch_apg_gen_grad.py):

- `contact_cotangents_dropped`: the PBD backward ignores the cotangents of
  the contact impulses (Info.contact.vel/.ang), which ant's reward reads;
- `linearised_at_outputs`: the PBD backward runs the twin from the step's
  outputs, not from its inputs;
- `act_grad_zeroed`: the PBD backward returns a zero gradient for the
  action;
- `v2_backward_through_gen_step_plain`: the generalized backward
  differentiates the kernel's plain version (`gen_step_plain`, the
  kernel's semantics) in place of the pipeline's steps (the JAX package's
  `jnp_path`).

`planted(name)` swaps the Function for the planted one inside the block
(`kernels.pbd_step` and `generalized.kernels.kernel_step` look it up at
each call).
"""

import contextlib

import torch

from brax_torch.sim import kernels
from brax_torch.v2.generalized import kernels as gen_kernels

# the Functions as shipped, which `planted` swaps out
PBD_STEP, GEN_STEP = kernels.PBDStep, gen_kernels.GenStep


class ContactCotangentsDropped(PBD_STEP):
    @staticmethod
    def backward(ctx, *grads):
        grads = grads[:4] + tuple(torch.zeros_like(g) for g in grads[4:])
        return PBD_STEP.backward(ctx, *grads)


class ActGradZeroed(PBD_STEP):
    @staticmethod
    def backward(ctx, *grads):
        out = PBD_STEP.backward(ctx, *grads)
        return out[:-1] + (torch.zeros_like(out[-1]),)


class LinearisedAtOutputs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sys, pos, rot, vel, ang, act):
        ctx.sys = sys
        outs = kernels._plain_outputs(sys, pos, rot, vel, ang, act)
        ctx.save_for_backward(*outs[:4], act)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = kernels._plain_outputs(ctx.sys, *ins)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            dins = torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs],
                                       allow_unused=True)
        return (None, *dins)


class BackwardThroughGenStepPlain(GEN_STEP):
    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            state = gen_kernels.with_float_leaves(ctx.skeleton, ins[1:])
            new = gen_kernels.gen_step_state(ctx.sys, state, ins[0], ctx.n_frames)
            pairs = [(o, g) for o, g in zip(gen_kernels.float_leaves(new), grads)
                     if o.requires_grad]
            dins = torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs],
                                       allow_unused=True)
        return (None, None, None, *dins)


FAULTS = {
    "contact_cotangents_dropped": ("PBDStep", ContactCotangentsDropped),
    "linearised_at_outputs": ("PBDStep", LinearisedAtOutputs),
    "act_grad_zeroed": ("PBDStep", ActGradZeroed),
    "v2_backward_through_gen_step_plain": ("GenStep", BackwardThroughGenStepPlain),
}


@contextlib.contextmanager
def planted(name):
    attr, fault = FAULTS[name]
    module = kernels if attr == "PBDStep" else gen_kernels
    prev = getattr(module, attr)
    setattr(module, attr, fault)
    try:
        yield
    finally:
        setattr(module, attr, prev)


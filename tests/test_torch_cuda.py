"""The CUDA PBD kernel against its plain-torch twin, on a CUDA card.

These tests skip without a card.  This file imports no JAX, so that it runs
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from brax_torch.envs.ant import Ant
from brax_torch.sim import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _contact_state(device, n=256, steps=10):
    """n ant envs after `steps` twin steps (contact-rich), and one more action."""
    env = Ant(use_contact_forces=True, batch_size=n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    qp = env.reset(gen).qp
    for _ in range(steps):
        act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
        qp, _ = kernels.pbd_step_plain(env.sys, qp, act)
    return env, qp, torch.rand((n, 8), generator=gen, device=device) * 2 - 1


def test_kernel_matches_twin_in_contact(cuda):
    env, qp, act = _contact_state(cuda)
    before = kernels.pbd_step_soa.launches
    out, info = kernels.pbd_step(env.sys, qp, act)
    torch.cuda.synchronize()
    assert kernels.pbd_step_soa.launches == before + 1
    ref, info_ref = kernels.pbd_step_plain(env.sys, qp, act)
    torch.testing.assert_close(out.pos, ref.pos, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.rot, ref.rot, rtol=0, atol=1e-4)
    torch.testing.assert_close(out.vel, ref.vel, rtol=0, atol=3e-3)
    torch.testing.assert_close(out.ang, ref.ang, rtol=0, atol=3e-3)
    torch.testing.assert_close(info.contact.vel, info_ref.contact.vel, rtol=0, atol=3e-3)
    torch.testing.assert_close(info.contact.ang, info_ref.contact.ang, rtol=0, atol=3e-3)


def test_kernel_raises_on_unsupported_system(cuda):
    env, qp, act = _contact_state(cuda, n=32, steps=0)
    other = dataclasses.replace(env.sys, collider_cutoff=4)
    with pytest.raises(NotImplementedError, match="collider_cutoff"):
        kernels.pbd_step(other, qp, act)


def test_kernel_rejects_cpu_mixed_inputs(cuda):
    env, qp, act = _contact_state(cuda, n=32, steps=0)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.pbd_step(env.sys, qp, act.cpu())

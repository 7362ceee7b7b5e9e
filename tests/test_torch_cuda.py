"""The CUDA kernels (PBD step, fused MLP, generalized step, the launch-overhead
probe) against their plain versions, on a CUDA card.

These tests skip without a card.  This file imports no JAX, so that it runs
where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import dataclasses

import pytest
import torch

from brax_torch import cuda_build
from brax_torch.envs.ant import Ant
from brax_torch.sim import kernels
from brax_torch.tools import probe_overhead as probe
from brax_torch.training import fused_mlp
from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels as gen_kernels

from tests.torch_parity import one_torch_thread  # noqa: F401


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


# ---------------------------------------------------------------------------
# fused MLP kernels
# ---------------------------------------------------------------------------

# f32: tests/test_fused_mlp.py's tolerances; bf16: BF16_REL of the largest
# plain-version value (tests/test_torch_fused_mlp.py)
BF16_REL = 1e-2


def _chain(device, lead, d0, sizes, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dims = [d0, *sizes]
    x = torch.randn(lead + (d0,), generator=gen)
    ws = [(torch.rand((a, b), generator=gen) * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn((b,), generator=gen) * 0.1 for b in dims[1:]]
    g = torch.randn(lead + (dims[-1],), generator=gen)
    to = lambda t: t.to(device)
    return to(x), [to(w) for w in ws], [to(b) for b in bs], to(g)


def _close(got, want, bf16, kind):
    if bf16:
        err = float((got - want).abs().max())
        assert err <= BF16_REL * float(want.abs().max()), (kind, err)
    elif kind == "fwd":
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("lead,d0,sizes,activation", [
    ((137,), 87, (256,) * 5 + (1,), "swish"),
    ((137,), 87, (32,) * 4 + (16,), "swish"),
    ((137,), 27, (256,) * 5 + (1,), "swish"),
    ((137,), 27, (32,) * 4 + (16,), "swish"),
    ((64,), 87, (64, 64, 8), "relu"),
    ((33,), 87, (40, 3), "tanh"),
    ((5, 33), 29, (64, 7), "swish"),
])
def test_fused_kernels_match_plain(cuda, lead, d0, sizes, activation, bf16):
    x, ws, bs, g = _chain(cuda, lead, d0, sizes)
    x2, g2 = x.reshape(-1, d0), g.reshape(-1, sizes[-1])
    y = fused_mlp.chain_fwd(x2, ws, bs, activation, bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x2, ws, bs, g2, activation, bf16)
    torch.cuda.synchronize()
    _close(y, fused_mlp.chain_fwd_plain(x2, ws, bs, activation, bf16), bf16, "fwd")
    pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x2, ws, bs, g2, activation, bf16)
    for got, want in zip([dx, *dws, *dbs], [pdx, *pdws, *pdbs]):
        _close(got, want, bf16, "bwd")


def test_dense_chain_autograd_launches_both_kernels(cuda):
    x, ws, bs, g = _chain(cuda, (5, 33), 29, (64, 7))
    ws = [w.requires_grad_() for w in ws]
    bs = [b.requires_grad_() for b in bs]
    x.requires_grad_()
    fwd0, bwd0 = fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches
    y = fused_mlp.dense_chain(x, ws, bs, activation="swish", matmul_dtype=torch.float32)
    assert fused_mlp.chain_fwd.launches == fwd0 + 1 and y.shape == (5, 33, 7)
    y.backward(g)
    assert fused_mlp.chain_bwd.launches == bwd0 + 1
    ref = [t.detach().clone().requires_grad_() for t in (x, *ws, *bs)]
    y_ref = fused_mlp.dense_chain_plain(ref[0], ref[1:3], ref[3:], "swish", torch.float32)
    y_ref.backward(g)
    _close(y, y_ref, False, "fwd")
    for got, want in zip((x, *ws, *bs), ref):
        _close(got.grad, want.grad, False, "bwd")


def test_fused_kernels_raise_on_width_above_max(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (fused_mlp.MAX_WIDTH + 1, 2))
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_WIDTH + 1)):
        fused_mlp.chain_fwd(x, ws, bs)
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_WIDTH + 1)):
        fused_mlp.chain_bwd(x, ws, bs, g)


def test_fused_kernels_reject_cpu_mixed_inputs(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_mlp.chain_fwd(x, [ws[0].cpu(), ws[1]], bs)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_mlp.chain_bwd(x, ws, bs, g.cpu())


def test_fused_counters_advance_by_one_per_call(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16, 2))
    for _ in range(3):
        fwd0, bwd0 = fused_mlp.chain_fwd.launches, fused_mlp.chain_bwd.launches
        fused_mlp.chain_fwd(x, ws, bs)
        assert fused_mlp.chain_fwd.launches == fwd0 + 1
        fused_mlp.chain_bwd(x, ws, bs, g)
        assert fused_mlp.chain_bwd.launches == bwd0 + 1


# ---------------------------------------------------------------------------
# generalized step (v2)
# ---------------------------------------------------------------------------

# tests/test_v2_generalized_kernel.py's tolerances
GEN_TOL = {"q": 2e-5, "qd": 2e-4, "minv": 2e-5, "x_pos": 2e-5, "x_rot": 2e-5, "xd_ang": 2e-4,
           "xd_vel": 2e-4, "c_pos": 2e-5, "c_pen": 2e-5}


def _gen_state(device, n, steps=10):
    """n v2 ants after `steps` plain-version env steps, and one more action."""
    env = v2_envs.create("ant", batch_size=n, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    ps = env.reset(gen).pipeline_state
    q, qd, minv = ps.q, ps.qd, ps.mass_mx_inv
    for _ in range(steps):
        act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
        out = gen_kernels.gen_step_plain(env.sys, q, qd, minv, act, 5)
        q, qd, minv = out["q"], out["qd"], out["minv"]
    act = torch.rand((n, 8), generator=gen, device=device) * 2 - 1
    return env.unwrapped.sys, (q, qd, minv, act)


@pytest.mark.parametrize("n", [128, 4096])
@pytest.mark.parametrize("n_frames", [1, 5])
def test_gen_kernel_matches_plain(cuda, n, n_frames):
    """Every env within tolerance at one frame; at five, where contact
    thresholds can fall apart by rounding, all but 1 in 1000."""
    sys, ins = _gen_state(cuda, n)
    before = gen_kernels.gen_step_soa.launches
    got = gen_kernels.gen_step(sys, *ins, n_frames)
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 1
    want = gen_kernels.gen_step_plain(sys, *ins, n_frames)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, tol in GEN_TOL.items():
        assert torch.isfinite(got[k]).all(), k
        inside &= (got[k] - want[k]).abs().reshape(n, -1).amax(dim=1) <= tol
    assert int((~inside).sum()) <= (0 if n_frames == 1 else n // 1000), int((~inside).sum())


def test_gen_kernel_matches_plain_in_contact(cuda):
    """Five frames from a contact-rich reset (the torso lowered by up to
    0.35), 4096 envs: all but 1 in 1000 within tolerance."""
    n = 4096
    env = v2_envs.create("ant", batch_size=n, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q_noise = torch.rand((n, 15), generator=gen, device=cuda) * 0.2 - 0.1
    q_noise[:, 2] -= torch.rand(n, generator=gen, device=cuda) * 0.35
    ps = env.unwrapped.reset_from_noise(
        q_noise, 0.1 * torch.randn((n, 14), generator=gen, device=cuda)).pipeline_state
    assert float((ps.contact.penetration > 0).any(dim=1).float().mean()) > 0.5
    ins = (ps.q, ps.qd, ps.mass_mx_inv, torch.rand((n, 8), generator=gen, device=cuda) * 2 - 1)
    got = gen_kernels.gen_step(env.unwrapped.sys, *ins, 5)
    want = gen_kernels.gen_step_plain(env.unwrapped.sys, *ins, 5)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, tol in GEN_TOL.items():
        inside &= (got[k] - want[k]).abs().reshape(n, -1).amax(dim=1) <= tol
    assert int((~inside).sum()) <= n // 1000, int((~inside).sum())


def test_gen_env_step_launches_once_per_step(cuda):
    env = v2_envs.create("ant", batch_size=256, device=cuda)
    state = env.reset(torch.Generator(device=cuda).manual_seed(1))
    before = gen_kernels.gen_step_soa.launches
    for _ in range(3):
        state = env.step(state, torch.zeros((256, 8), device=cuda))
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 3
    assert state.obs.shape == (256, 27) and torch.isfinite(state.obs).all()


def test_gen_kernel_raises_on_unsupported_system_and_cpu_inputs(cuda):
    sys, ins = _gen_state(cuda, 32, steps=0)
    other = dataclasses.replace(sys, actuator_types="p" * 8)
    with pytest.raises(NotImplementedError, match="actuator types"):
        gen_kernels.gen_step(other, *ins, 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        gen_kernels.gen_step(sys, *ins[:3], ins[3].cpu(), 1)


# the v2 envs beside ant that the generalized kernel covers
V2_ENVS = ("inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah", "hopper",
           "walker2d")


@pytest.fixture(scope="module")
def gen_scenes():
    """Builds the kernel of every v2 scene at once, one nvcc each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    systems = [v2_envs.get_environment(name, device="cuda").sys for name in V2_ENVS]
    cuda_build.build(*(gen_kernels.kernel_source(s) for s in systems))


@pytest.mark.parametrize("name", V2_ENVS)
def test_gen_kernel_matches_plain_per_env(cuda, gen_scenes, name):
    """128 envs of each scene: three env steps, one launch each, then one
    kernel call against the plain version at the env's n_frames, every env
    within tolerance."""
    n = 128
    env = v2_envs.create(name, batch_size=n, device=cuda)
    bare = env.unwrapped
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = env.reset(gen)
    act = lambda: torch.rand((n, bare.action_size), generator=gen, device=cuda) * 2 - 1
    before = gen_kernels.gen_step_soa.launches
    for _ in range(3):
        state = env.step(state, act())
    torch.cuda.synchronize()
    assert gen_kernels.gen_step_soa.launches == before + 3
    assert torch.isfinite(state.obs).all()
    ps = state.pipeline_state
    ins = (ps.q, ps.qd, ps.mass_mx_inv, act())
    got = gen_kernels.gen_step(bare.sys, *ins, bare._n_frames)
    want = gen_kernels.gen_step_plain(bare.sys, *ins, bare._n_frames)
    assert sorted(got) == sorted(want)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, v in want.items():
        assert torch.isfinite(got[k]).all(), k
        inside &= (got[k] - v).abs().reshape(n, -1).amax(dim=1) <= GEN_TOL[k]
    assert bool(inside.all()), int((~inside).sum())


# ---------------------------------------------------------------------------
# launch-overhead probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k", [(64, 3), (512, 6), (5120, 24)])
def test_probe_dot_chain_matches_plain(cuda, rows, k):
    """bf16 products with f32 sums, summed in another order than the plain
    version's: max |err| <= 1e-2 max |plain| (the fused MLP's bf16 rule)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + k)
    x = torch.randn((rows, probe.WIDTH), generator=gen, device=cuda)
    w = torch.randn((probe.WIDTH, probe.WIDTH), generator=gen, device=cuda) * 0.05
    before = probe.dot_chain.launches
    got = probe.dot_chain(x, w, k)
    torch.cuda.synchronize()
    assert probe.dot_chain.launches == before + 1
    want = probe.dot_chain_plain(x, w, k)
    assert float((got - want).abs().max()) <= BF16_REL * float(want.abs().max())


@pytest.mark.parametrize("blocks", [1, 10, 40])
def test_probe_copy_plus_one_is_exact(cuda, blocks):
    x = torch.randn(probe.TILE, device=cuda)
    before = probe.copy_plus_one.launches
    got = probe.copy_plus_one(x, blocks)
    torch.cuda.synchronize()
    assert probe.copy_plus_one.launches == before + 1
    assert torch.equal(got, probe.copy_plus_one_plain(x))


def test_probe_wrappers_raise_on_bad_inputs(cuda):
    x = torch.zeros((8, probe.WIDTH), device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        probe.dot_chain(x, torch.zeros((probe.WIDTH, probe.WIDTH)), 2)
    with pytest.raises(ValueError, match="takes"):
        probe.dot_chain(x[:, :128].contiguous(), torch.zeros((128, 128), device=cuda), 2)
    with pytest.raises(ValueError, match="at least one"):
        probe.dot_chain(x, torch.zeros((probe.WIDTH, probe.WIDTH), device=cuda), 0)


def test_probe_measure_times_every_key(cuda):
    replayed = probe.copy_plus_one.replayed, probe.dot_chain.replayed
    r = probe.result(probe.measure())
    keys = ("trivial_us", "grid10_us", "grid40_us", "dotchain6_us", "dotchain24_us",
            "dotchain5120_6_us", "dotchain5120_24_us", "fwd1_us", "fwd10_us")
    for key in keys:
        assert r[key] > 0 and r["host"][key] > 0, key
    assert sorted(r["cublas_chain"]) == sorted(k for k in keys if k.startswith("dotchain"))
    assert r["torch_add_trivial"]["graph"] > 0 and r["torch_add_trivial"]["host"] > 0
    # every graph replays its launches BATCHES + 1 times
    assert probe.copy_plus_one.replayed - replayed[0] == 3 * (probe.BATCHES + 1) * probe.LENGTH
    assert probe.dot_chain.replayed - replayed[1] == 4 * (probe.BATCHES + 1) * probe.CHAIN_LENGTH

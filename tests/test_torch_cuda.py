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
    before = kernels.pbd_step_launch.launches
    out, info = kernels.pbd_step(env.sys, qp, act)
    torch.cuda.synchronize()
    assert kernels.pbd_step_launch.launches == before + 1
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


def _rounding_rule_holds(sys, qp, act, device):
    """chip_smoke.py's rule: every output within TOLERANCE of the twin, but
    for at most MAX_OUTLIERS envs, each one whose result float rounding
    decides (chip_smoke.max_errors raises otherwise)."""
    import chip_smoke

    gen = torch.Generator(device=device).manual_seed(7)
    _, _, outliers = chip_smoke.max_errors(sys, qp, act, gen)
    assert outliers <= chip_smoke.MAX_OUTLIERS


@pytest.mark.parametrize("n", [1, 128, 2048, 4097])
def test_generated_kernel_matches_twin_by_batch(cuda, n):
    env, qp, act = _contact_state(cuda, n=n)
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(env.sys, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


def test_generated_kernel_matches_twin_on_two_legged_ant(cuda):
    from tests.test_torch_pbd_launch import Scene, scene_state, two_legged_ant_config

    env = Scene(two_legged_ant_config(), batch_size=1000, device=cuda)
    assert kernels.plan(env.sys).lanes == 8
    qp, act = scene_state(env, 1000, steps=10, seed=1, device=cuda)
    _rounding_rule_holds(env.sys, qp, act, cuda)


def test_generated_kernel_gives_the_same_bits_twice(cuda):
    env, qp, act = _contact_state(cuda, n=2048)
    a, info_a = kernels.pbd_step(env.sys, qp, act)
    b, info_b = kernels.pbd_step(env.sys, qp, act)
    for x, y in zip((a.pos, a.rot, a.vel, a.ang, info_a.contact.vel, info_a.contact.ang),
                    (b.pos, b.rot, b.vel, b.ang, info_b.contact.vel, info_b.contact.ang)):
        assert torch.equal(x, y)


def test_generated_kernel_replays_from_a_cuda_graph(cuda):
    """A launch captured in a CUDA graph and replayed gives the eager bits."""
    env, qp, act = _contact_state(cuda, n=512)
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    for t in (got.pos, got.vel, info_got.contact.ang):
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip((want.pos, want.rot, want.vel, want.ang, info_want.contact.vel),
                    (got.pos, got.rot, got.vel, got.ang, info_got.contact.vel)):
        assert torch.equal(x, y)
    assert torch.equal(info_want.contact.ang, info_got.contact.ang)


def _humanoid_state(name, device, n, steps=10, seed=0):
    """n envs of a spherical scene (humanoid or humanoidstandup) after
    `steps` twin steps from reset noise (feet or body on the floor), and one
    more action."""
    from tests.test_torch_pbd_launch import Scene, _config, scene_state

    env = Scene(_config(name), batch_size=n, device=device)
    return env, *scene_state(env, n, steps=steps, seed=seed, device=device)


@pytest.mark.parametrize("name", ["humanoid", "humanoidstandup"])
@pytest.mark.parametrize("n", [1, 2, 4097])
def test_spherical_kernel_matches_twin_by_batch(cuda, name, n):
    """The spherical joint rows and 3-dof actuators (PBD_SPHERICAL), on
    ragged batches in contact: humanoid 16 lanes (2 envs a warp),
    humanoidstandup 32 (1 env a warp)."""
    env, qp, act = _humanoid_state(name, cuda, n)
    assert kernels.plan(env.sys).spherical
    before = kernels.pbd_step_launch.launches
    _rounding_rule_holds(env.sys, qp, act, cuda)
    assert kernels.pbd_step_launch.launches == before + 1


def test_spherical_kernel_gives_the_same_bits_twice_and_from_a_graph(cuda):
    env, qp, act = _humanoid_state("humanoid", cuda, 1024)
    want, info_want = kernels.pbd_step(env.sys, qp, act)
    again, info_again = kernels.pbd_step(env.sys, qp, act)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.pbd_step(env.sys, qp, act)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, info_got = kernels.pbd_step(env.sys, qp, act)
    got.pos.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    fields = lambda q, i: (q.pos, q.rot, q.vel, q.ang, i.contact.vel, i.contact.ang)
    for x, y, z in zip(fields(want, info_want), fields(again, info_again),
                       fields(got, info_got)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_humanoid_env_step_launches_the_kernel_once(cuda):
    from brax_torch import envs

    for name in ("humanoid", "humanoid_legacy", "humanoidstandup"):
        env = envs.create(name, batch_size=64)
        state = env.reset(torch.Generator(device=cuda).manual_seed(0))
        before = kernels.pbd_step_launch.launches
        for _ in range(3):
            state = env.step(state, torch.zeros((64, 17), device=cuda))
        assert kernels.pbd_step_launch.launches == before + 3
        assert state.obs.shape == (64, 240) and bool(torch.isfinite(state.obs).all())


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
    ((137,), 240, (256,) * 5 + (1,), "swish"),
    ((137,), 240, (32,) * 4 + (34,), "swish"),
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


def _check_against_plain(x2, ws, bs, g2, activation, bf16):
    """Kernel against plain version, forward and backward, at the file's
    tolerances; returns the kernel's outputs."""
    y = fused_mlp.chain_fwd(x2, ws, bs, activation, bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x2, ws, bs, g2, activation, bf16)
    torch.cuda.synchronize()
    _close(y, fused_mlp.chain_fwd_plain(x2, ws, bs, activation, bf16), bf16, "fwd")
    pdx, pdws, pdbs = fused_mlp.chain_bwd_plain(x2, ws, bs, g2, activation, bf16)
    for got, want in zip([dx, *dws, *dbs], [pdx, *pdws, *pdbs]):
        _close(got, want, bf16, "bwd")
    return y, dx, dws, dbs


VALUE = (87, (256,) * 5 + (1,))
POLICY = (87, (32,) * 4 + (16,))


@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_give_the_same_bits_twice(cuda, chain):
    x, ws, bs, g = _chain(cuda, (5120,), *chain)
    first = [fused_mlp.chain_fwd(x, ws, bs), *_flat(fused_mlp.chain_bwd(x, ws, bs, g))]
    second = [fused_mlp.chain_fwd(x, ws, bs), *_flat(fused_mlp.chain_bwd(x, ws, bs, g))]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _flat(grads):
    dx, dws, dbs = grads
    return [dx, *dws, *dbs]


@pytest.mark.parametrize("rows", [1, 63, 65, 5127])
@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_ragged_rows(cuda, chain, rows):
    """1 row, one less and one more than the recipe plan's 64-row tile,
    and 5120 + 7 rows."""
    x, ws, bs, g = _chain(cuda, (rows,), *chain)
    _check_against_plain(x, ws, bs, g / rows, "swish", True)


@pytest.mark.parametrize("width", [1, 16, 27, 87, 255, 256])
def test_fused_kernels_at_every_width(cuda, width):
    x, ws, bs, g = _chain(cuda, (300,), width, (width, 64, width))
    _check_against_plain(x, ws, bs, g, "swish", True)


@pytest.mark.parametrize("d0,sizes", [(87, (16,)), (64, (64,) * 8), (256, (256,) * 8)],
                         ids=["1-layer", "8-layers", "8x256"])
def test_fused_kernels_one_and_eight_layers(cuda, d0, sizes):
    x, ws, bs, g = _chain(cuda, (700,), d0, sizes)
    _check_against_plain(x, ws, bs, g, "swish", True)


# relu' is a step at 0.  In bf16 mode a pre-activation near 0 can fall on
# either side in the kernel and in the plain version: their sums run in
# other orders, an activation then rounds to a neighbouring bf16 number, and
# the next layer's z moves by ~1e-3, so on the 256-wide chain some rows'
# gradients differ by their whole size.  relu is held here in bf16 forward
# (continuous) and in f32 mode backward, on the rows whose plain
# pre-activations all lie further than RELU_KINK from 0 (f32 sums differ by
# ~1e-6; some 90% of the rows); test_fused_kernels_match_plain holds the
# bf16 relu backward on a chain narrow enough to have no such row.
RELU_KINK = 1e-5


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_fused_kernels_relu_tanh_on_the_value_chain(cuda, activation):
    x, ws, bs, g = _chain(cuda, (1024,), *VALUE)
    g = g / 1024
    if activation == "tanh":
        _check_against_plain(x, ws, bs, g, activation, True)
        return
    y = fused_mlp.chain_fwd(x, ws, bs, activation, True)
    _close(y, fused_mlp.chain_fwd_plain(x, ws, bs, activation, True), True, "fwd")
    zs = fused_mlp._forward_plain(x, ws, bs, activation, False, keep=True)[2]
    clear = torch.stack([z.abs().amin(dim=1) for z in zs]).amin(dim=0) > RELU_KINK
    assert int(clear.sum()) > 900
    _check_against_plain(x[clear].contiguous(), ws, bs, g[clear].contiguous(), activation, False)


@pytest.mark.parametrize("chain", [VALUE, POLICY], ids=["value", "policy"])
def test_fused_kernels_f32_mode_ragged(cuda, chain):
    x, ws, bs, g = _chain(cuda, (5127,), *chain)
    _check_against_plain(x, ws, bs, g / 5127, "swish", False)


def test_dense_chain_captured_in_a_cuda_graph(cuda):
    """Forward and backward of dense_chain captured in one CUDA graph: the
    replay equals the eager result bit for bit."""
    x, ws, bs, g = _chain(cuda, (1024,), *VALUE)
    params = [t.requires_grad_() for t in (*ws, *bs)]

    def step():
        y = fused_mlp.dense_chain(x, params[:6], params[6:])
        return (y, *torch.autograd.grad(y, params, g))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    eager = step()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_fused_kernels_raise_on_a_chain_too_deep(cuda):
    x, ws, bs, g = _chain(cuda, (8,), 8, (16,) * (fused_mlp.MAX_LAYERS + 1))
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_LAYERS + 1)):
        fused_mlp.chain_fwd(x, ws, bs)
    with pytest.raises(NotImplementedError, match=str(fused_mlp.MAX_LAYERS + 1)):
        fused_mlp.chain_bwd(x, ws, bs, g)


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


@pytest.mark.parametrize("name", ["ant", "halfcheetah"])
@pytest.mark.parametrize("n", [1, 33, 4095])
def test_gen_kernel_ragged_batches(cuda, gen_scenes, name, n):
    """A warp per env, several envs per block: at ragged batch sizes every
    env matches the plain version bit for bit, or within tolerance in all
    but 1 in 1000 (chip_smoke.py's rule), and its outputs do not depend on
    how many envs share its block."""
    env = v2_envs.create(name, batch_size=n, device=cuda)
    bare = env.unwrapped
    gen = torch.Generator(device=cuda).manual_seed(n)
    act = lambda: torch.rand((n, bare.action_size), generator=gen, device=cuda) * 2 - 1
    state = env.reset(gen)
    for _ in range(2):
        state = env.step(state, act())
    ps = state.pipeline_state
    ins = (ps.q, ps.qd, ps.mass_mx_inv, act())
    nf = bare._n_frames
    got = gen_kernels.gen_step(bare.sys, *ins, nf)
    want = gen_kernels.gen_step_plain(bare.sys, *ins, nf)
    identical = torch.ones(n, dtype=torch.bool, device=cuda)
    inside = torch.ones(n, dtype=torch.bool, device=cuda)
    for k, v in want.items():
        assert torch.isfinite(got[k]).all(), k
        identical &= (got[k] == v).reshape(n, -1).all(dim=1)
        inside &= (got[k] - v).abs().reshape(n, -1).amax(dim=1) <= GEN_TOL[k]
    assert int((~inside).sum()) <= n // 1000, (int(identical.sum()), int((~inside).sum()))
    soa = tuple(x.reshape(n, -1).t().contiguous() for x in ins)
    top = gen_kernels.max_envs_per_block(gen_kernels.plan(bare.sys))
    base = gen_kernels.gen_step_soa(bare.sys, *soa, nf, block=1)
    for block in (2, top):
        other = gen_kernels.gen_step_soa(bare.sys, *soa, nf, block=block)
        assert all(torch.equal(other[k], base[k]) for k in base), block


def test_gen_kernel_rejects_blocks_past_its_shared_memory(cuda):
    sys, ins = _gen_state(cuda, 32, steps=0)
    soa = tuple(x.reshape(32, -1).t().contiguous() for x in ins)
    top = gen_kernels.max_envs_per_block(gen_kernels.plan(sys))
    with pytest.raises(ValueError, match="outside"):
        gen_kernels.gen_step_soa(sys, *soa, 1, block=top + 1)


# ---------------------------------------------------------------------------
# launch-overhead probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,k", [(64, 3), (512, 6), (5120, 24), (1, 1), (100, 6),
                                    (5121, 24), (512, 1)])
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

"""The generalized kernel's plain version against the Pallas kernel's math,
and the wrapper's CPU behaviour.  The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

`brax_tpu.v2.generalized.kernels._build_tile_frames` is the body of the
Pallas kernel that `brax_torch/csrc/gen_step.cu` replaces, written in jnp
on (field, sublane, lane) tiles.  Here it runs eagerly on a (1, 16) tile:
eager dispatch takes seconds, where jitting it for ant takes about a
minute of CPU compile per frame count.  Tolerances are those of
tests/test_v2_generalized_kernel.py (q, x and contacts 2e-5, velocities
2e-4; its per-env distribution bounds for chained steps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brax_tpu.v2.generalized import kernels as jax_kernels
from brax_torch.v2 import mjcf
from brax_torch.v2.base import Capsule, Sphere
from brax_torch.v2.envs import assets
from brax_torch.v2.generalized import kernels

from tests import torch_parity as tp
from tests.torch_parity import one_torch_thread  # noqa: F401

TIGHT = ("q", "x_pos", "x_rot", "c_pos", "c_pen", "minv")


@pytest.fixture(scope="module")
def sys():
    return mjcf.loads(assets.ant_xml(), device="cpu")


@pytest.fixture(scope="module")
def start():
    """(q, qd, M^-1, act) numpy: the JAX init state of v2_inputs, in contact."""
    q, qd, act = tp.v2_inputs()
    s0, _ = tp.jax_v2_states()
    return q, qd, np.array(s0.mass_mx_inv), act


def _tile_frames(n_frames, q, qd, minv, act):
    """The Pallas kernel body, eagerly, on a (1, N) tile; outputs (N, ...)."""
    fn, _ = jax_kernels._build_tile_frames(tp.jax_v2_ant().sys, n_frames, (1, q.shape[0]))
    tile = lambda x: jnp.asarray(np.moveaxis(x, 0, -1)[..., None, :])
    out = fn(*(tile(x) for x in (q, qd, minv, act)))
    return {k: np.moveaxis(np.asarray(v)[..., 0, :], -1, 0) for k, v in out.items()}


@pytest.mark.parametrize("n_frames", [1, 2])
def test_plain_matches_pallas_kernel_math(sys, start, n_frames):
    want = _tile_frames(n_frames, *start)
    got = kernels.gen_step_plain(sys, *(torch.from_numpy(x) for x in start[:3]),
                                 torch.from_numpy(start[3]), n_frames)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        tol = 2e-5 if k in TIGHT else 2e-4
        np.testing.assert_allclose(got[k].numpy(), v, rtol=tol, atol=tol, err_msg=k)


def test_chained_steps_match_jnp_pipeline(sys, start):
    """Two chained 1-frame steps against two jnp pipeline steps: the kernel's
    M^-1 refreshes at the start of a frame, the pipeline's at the end of
    one, so chaining shows that the carried inverse lines up."""
    q, qd, minv, _ = start
    acts = 0.2 * np.random.RandomState(11).randn(2, tp.N_ENVS, tp.V2_NA).astype(np.float32)
    want = tp.jax_v2_states()[0]
    carry = tuple(torch.from_numpy(x) for x in (q, qd, minv))
    for a in acts:
        want = tp.jax_v2_step()(want, a)
        out = kernels.gen_step_plain(sys, *carry, torch.from_numpy(a), 1)
        carry = (out["q"], out["qd"], out["minv"])
    dq = np.abs(carry[0].numpy() - np.asarray(want.q)).max(axis=1)
    dqd = np.abs(carry[1].numpy() - np.asarray(want.qd)).max(axis=1)
    assert np.median(dq) < 5e-5 and np.median(dqd) < 5e-4, (np.median(dq), np.median(dqd))
    assert np.percentile(dq, 90) < 1e-3 and np.percentile(dqd, 90) < 1e-2
    assert np.isfinite(carry[0].numpy()).all() and np.isfinite(carry[1].numpy()).all()


def test_wrapper_runs_the_plain_version_on_cpu(sys, start):
    ins = [torch.from_numpy(x) for x in start]
    before = kernels.gen_step_soa.launches
    got = kernels.gen_step(sys, *ins, 2)
    want = kernels.gen_step_plain(sys, *ins, 2)
    assert kernels.gen_step_soa.launches == before
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    shapes = kernels.out_shapes(sys)
    assert {k: tuple(v.shape[1:]) for k, v in got.items()} == shapes
    assert shapes["minv"] == (14, 14) and shapes["c_pen"] == (4,)


def test_mm_upper_is_the_products_upper_triangle_mirrored():
    """The symmetric products compute only the upper triangle, each entry in
    the order of the full product's, so the two agree bit for bit there."""
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randn(3, 14, 14).astype(np.float32)) for _ in range(2))
    full, upper = kernels._mm(a, b), kernels._mm_upper(a, b)
    iu = torch.triu_indices(14, 14)
    assert torch.equal(upper[:, iu[0], iu[1]], full[:, iu[0], iu[1]])
    assert torch.equal(upper, upper.transpose(1, 2))
    torch.testing.assert_close(full, a @ b, rtol=1e-5, atol=1e-5)


def test_tables_and_scene_header(sys):
    p = kernels.plan(sys)
    assert (p.nl, p.nq, p.nd, p.nc, p.nr) == (9, 15, 14, 4, 24)
    tab = kernels.pack_tables(sys)
    na = len(p.act_qdid)
    assert tab.dtype == np.float32
    assert tab.shape == (kernels.GLOBAL_SIZE + p.nl * kernels.LINK_SIZE + p.nd * kernels.DOF_SIZE
                         + na * kernels.ACT_SIZE + p.nc * kernels.CONTACT_SIZE,)
    np.testing.assert_allclose(tab[0], sys.dt.item())
    link = tab[kernels.GLOBAL_SIZE:].reshape(-1)[:p.nl * kernels.LINK_SIZE]
    np.testing.assert_allclose(link.reshape(p.nl, -1)[:, 30], sys.link.inertia.mass.numpy())
    header = kernels.scene_header(sys)
    for line in ("#define GS_ND 14", "#define GS_NR 24", "#define GS_ITERS 4",
                 "PARENT[9] = {-1, 0, 1, 0, 3, 0, 5, 0, 7}", "C_LINK[4] = {2, 4, 6, 8}"):
        assert line in header
    src = kernels.kernel_source(sys)
    assert src.read_text().endswith(kernels.SOURCE.read_text())
    assert "--fmad=false" in " ".join(kernels.cuda_build.source_flags(src))


def test_supported_names_missing_features(sys):
    assert kernels.supported(sys)
    ga, gb = sys.contacts[0]
    other = dataclasses.replace(sys, actuator_types="mp" * 4,
                                contacts=[(gb, ga), (ga, dataclasses.replace(gb, link_idx=0))])
    assert kernels.unsupported_features(other) == [
        "actuator types ['p']", "Plane-Sphere contacts", "planes on a link"]
    with pytest.raises(NotImplementedError, match="actuator types"):
        kernels.gen_step_plain(other, *(torch.zeros(1, n) for n in (15, 14)),
                               torch.zeros(1, 14, 14), torch.zeros(1, 8), 1)
    assert isinstance(ga, Sphere) and not isinstance(ga, Capsule)

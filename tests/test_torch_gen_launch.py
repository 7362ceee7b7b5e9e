"""The generalized kernel's launch, reckoned on the host: the shared memory
of a warp-per-env workspace, envs per block, resident blocks per SM and
the grid.  Needs neither JAX nor a card; the kernel itself is held against
its plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import types

import pytest

from brax_torch.v2 import envs as v2_envs
from brax_torch.v2.generalized import kernels

from tests.torch_parity import one_torch_thread  # noqa: F401

SCENES = ("ant", "inverted_pendulum", "inverted_double_pendulum", "reacher", "halfcheetah",
          "hopper", "walker2d")
H100_SMS = 132


@pytest.fixture(scope="module")
def systems():
    return {name: v2_envs.get_environment(name, device="cpu").sys for name in SCENES}


def _plan(nd, nr, nl=12, nq=30, nc=16, na=20, nlim=20):
    """A plan of the given sizes, for scenes the envs do not have."""
    return types.SimpleNamespace(nl=nl, nq=nq, nd=nd, nc=nc, nr=nr, act_qdid=list(range(na)),
                                 lim_dofs=list(range(nlim)))


@pytest.mark.parametrize("name", SCENES)
def test_workspace_fits_and_the_grid_covers_ragged_batches(systems, name):
    p = kernels.plan(systems[name])
    ws, fixed = kernels.workspace_bytes(p), kernels.block_fixed_bytes(p)
    top = kernels.max_envs_per_block(p)
    assert 1 <= top <= kernels.MAX_ENVS_PER_BLOCK
    assert fixed + top * ws <= kernels.MAX_SMEM_PER_BLOCK
    assert top == kernels.MAX_ENVS_PER_BLOCK or fixed + (top + 1) * ws > kernels.MAX_SMEM_PER_BLOCK
    header = kernels.scene_header(systems[name])
    assert f"#define GS_WS_BYTES {ws}\n" in header and f"#define GS_FIXED_BYTES {fixed}\n" in header
    for n in (1, 33, 4095):
        default = kernels.default_envs_per_block(p, n, H100_SMS)
        assert 1 <= default <= top
        for block in {1, default, top}:
            blocks, threads, smem = kernels.launch_geometry(p, n, block)
            assert threads == 32 * block
            assert smem == fixed + block * ws <= kernels.MAX_SMEM_PER_BLOCK
            assert (blocks - 1) * block < n <= blocks * block
    with pytest.raises(ValueError, match="envs_per_block"):
        kernels.launch_geometry(p, 33, top + 1)


@pytest.mark.parametrize("name,registers,blocks", [
    # resident blocks per SM at 1, 2, ... envs per block, as the CUDA
    # runtime's occupancy calculator gave them on an H100 for these builds
    ("ant", 128, [16, 8, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1]),
    ("halfcheetah", 110, [12, 7, 4, 3, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1]),
    ("walker2d", 107, [15, 8, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1]),
    ("inverted_double_pendulum", 95, [20, 10, 6, 5, 4, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1]),
])
def test_resident_blocks_match_the_runtime(systems, name, registers, blocks):
    p = kernels.plan(systems[name])
    assert [kernels.envs_per_sm(p, e, registers) // e
            for e in range(1, kernels.max_envs_per_block(p) + 1)] == blocks


def test_default_block_takes_the_fewest_waves():
    """Ant at 128 registers: 16 envs per SM whatever the block, so the
    largest block; a block of 9 would take two waves at 2048 envs."""
    p = _plan(nd=14, nr=24, nl=9, nq=15, nc=4, na=8, nlim=8)
    assert kernels.default_envs_per_block(p, 2048, H100_SMS, 128) == 16
    assert kernels.default_envs_per_block(p, 16384, H100_SMS, 128) == 16


def test_humanoid_sized_plan_fits_and_oversize_plan_raises():
    humanoid = _plan(nd=23, nr=80)
    assert kernels.workspace_bytes(humanoid) < 60_000
    assert kernels.max_envs_per_block(humanoid) >= 3
    big = _plan(nd=64, nr=256)
    with pytest.raises(NotImplementedError, match=r"\d+ bytes of shared memory for one env"):
        kernels.max_envs_per_block(big)
    with pytest.raises(NotImplementedError, match="232448"):
        kernels.launch_geometry(big, 8, 1)

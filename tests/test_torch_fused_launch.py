"""The fused MLP kernels' launch, reckoned on the host: `fused_mlp.plan`'s
pipeline stages (CTAs per cluster), row tile, grid, shared memory and
scratch.  Needs neither JAX
nor a card; the kernels themselves are held against their plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
import types

import pytest
import torch

from brax_torch.training import fused_mlp

from tests.torch_parity import one_torch_thread  # noqa: F401

H100_SMS = 132
SOURCE = fused_mlp.SOURCE.read_text()
# the chains of the PPO paths (87-wide v1 ant, 27-wide v2 ant, 240-wide
# humanoid observation; humanoid's 17 actions make a 34-wide policy head)
# and the row counts they run at: minibatch losses (5120 for ant, 10,240 for
# humanoid), the rollout's policy, the bootstrap value, an evaluation of 128
# envs
PPO_CHAINS = {"value": [87] + [256] * 5 + [1], "policy": [87] + [32] * 4 + [16],
              "value_v2": [27] + [256] * 5 + [1], "policy_v2": [27] + [32] * 4 + [16],
              "value_humanoid": [240] + [256] * 5 + [1],
              "policy_humanoid": [240] + [32] * 4 + [34]}
PPO_ROWS = (10240, 5120, 2048, 1024, 128)
WIDEST = [fused_mlp.MAX_WIDTH] * (fused_mlp.MAX_LAYERS + 1)


def _source_chains():
    return {name: [int(v) for v in body.split(",")]
            for name, body in re.findall(r"constexpr int (\w+)\[\] = \{([^}]*)\};", SOURCE)}


def _layout_checks():
    return [tuple(int(v) if v.strip().isdigit() else v.strip() for v in args.split(","))
            for args in re.findall(r"^LAYOUT_CHECK\(([^)]*)\);", SOURCE, flags=re.M)]


def test_the_source_checks_its_layout():
    assert len(_layout_checks()) >= 6


@pytest.mark.parametrize("check", _layout_checks(), ids=lambda c: "-".join(map(str, c[:4])))
def test_plan_mirrors_the_kernels_layout(check):
    """fused_mlp.cu holds make_layout to these bytes and stages with
    static_asserts; layout must give the same."""
    name, rows, x_stages, backward, want, want_stages = check
    lay = fused_mlp.layout(_source_chains()[name], rows, x_stages, bool(backward))
    assert (lay["bytes"], len(lay["stages"])) == (want, want_stages)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("chain", sorted(PPO_CHAINS))
def test_every_ppo_chain_fits_at_every_row_count(chain, backward):
    for rows in PPO_ROWS:
        p = fused_mlp.plan(PPO_CHAINS[chain], rows, H100_SMS, backward)
        assert p["smem"] <= fused_mlp.SMEM_LIMIT
        lay = fused_mlp.layout(PPO_CHAINS[chain], p["rows_per_tile"], p["x_stages"], backward)
        assert p["smem"] == lay["bytes"] and p["layers_per_stage"] == lay["stages"]
        # the stages take every layer once, in order
        assert [i for lo, hi in lay["stages"] for i in range(lo, hi + 1)] == list(
            range(len(PPO_CHAINS[chain]) - 1))
        assert p["launches"] == (2 if backward else 1)


def test_the_recipes_value_chain_spreads_over_the_card():
    """The value chain at 5120 and at 1024 rows, and the policy at the
    rollout's 2048, launch at least 80 CTAs (the value chain's 1024 rows
    forward: 16 tiles of 64 rows through 5-stage pipelines)."""
    for chain, rows in (("value", 5120), ("value", 1024), ("policy", 2048), ("value_v2", 1024)):
        for backward in (False, True):
            p = fused_mlp.plan(PPO_CHAINS[chain], rows, H100_SMS, backward)
            assert p["grid"] >= 80, (chain, rows, backward, p)


@pytest.mark.parametrize("rows", [1, 1024, 5120])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_the_widest_chain_fits_or_raises(rows, backward):
    try:
        p = fused_mlp.plan(WIDEST, rows, H100_SMS, backward)
    except NotImplementedError as e:
        assert str(fused_mlp.MAX_WIDTH) in str(e)
    else:
        assert p["smem"] <= fused_mlp.SMEM_LIMIT


def test_plan_raises_naming_a_chain_that_fits_nowhere(monkeypatch):
    monkeypatch.setattr(fused_mlp, "SMEM_LIMIT", 4096)
    with pytest.raises(NotImplementedError, match=r"\[87, 256, 1\]"):
        fused_mlp.plan([87, 256, 1], 64, H100_SMS)


def test_the_widest_chain_takes_a_stage_per_layer():
    for backward in (False, True):
        p = fused_mlp.plan(WIDEST, 5120, H100_SMS, backward)
        assert p["layers_per_stage"] == [(i, i) for i in range(fused_mlp.MAX_LAYERS)]


@pytest.mark.parametrize("rows", [0, 1, 15, 17, 63, 65, 1023, 5127])
@pytest.mark.parametrize("chain", ["value", "policy"])
def test_the_grid_covers_ragged_rows(chain, rows):
    for backward in (False, True):
        p = fused_mlp.plan(PPO_CHAINS[chain], rows, H100_SMS, backward,
                           max_clusters=lambda c, s: 16 if c == 8 else H100_SMS // c)
        m = p["rows_per_tile"]
        assert m in fused_mlp.ROW_TILES and 1 <= p["cluster"] <= fused_mlp.MAX_CLUSTER
        assert p["tiles"] * m >= rows > (p["tiles"] - 1) * m or rows == p["tiles"] == 0
        assert p["clusters"] == min(p["tiles"], 16 if p["cluster"] == 8 else H100_SMS // p["cluster"])
        assert p["grid"] == p["clusters"] * p["cluster"]
        # the persistent loop: cluster c takes tiles c, c + clusters, ...
        taken = sorted(t for c in range(p["clusters"]) for t in range(c, p["tiles"], p["clusters"]))
        assert taken == list(range(p["tiles"]))
        if backward:
            s, per = p["dw_slices"], p["dw_rows_per_slice"]
            assert per % fused_mlp.DW_ROWS == 0 and s >= 1
            assert s * per >= rows and (rows == 0 or (s - 1) * per < rows), (s, per)


def _carve(dims, n, rows, slices):
    """fused_mlp.cu's carve, reckoned again: a_i in bf16, act'(z_i) in f32
    (no last layer), g_i in bf16, db's per-tile partials, the dW partials
    and tickets, each part aligned."""
    align = lambda b: -(-b // 256) * 256
    pad = lambda d: -(-d // 16) * 16
    tiles = sum(-(-pad(a) // 64) * -(-pad(b) // 64) for a, b in zip(dims[:-1], dims[1:]))
    parts = [n * pad(d) * 2 for d in dims[:-1]] + [n * pad(d) * 4 for d in dims[1:-1]] + [0]
    parts += [n * pad(d) * 2 for d in dims[1:]]
    parts += [-(-n // rows) * sum(pad(d) for d in dims[1:]) * 4, slices * tiles * 64 * 64 * 4,
              tiles * 4]
    return sum(align(b) for b in parts)


@pytest.mark.parametrize("chain", sorted(PPO_CHAINS))
def test_scratch_follows_the_kernels_carve(chain):
    dims = PPO_CHAINS[chain]
    for rows in PPO_ROWS + (7,):
        p = fused_mlp.plan(dims, rows, H100_SMS, backward=True)
        assert p["scratch_bytes"] == _carve(dims, rows, p["rows_per_tile"], p["dw_slices"])
        assert [name for name, _ in p["scratch"]][:2] == ["a0", "a1"]


def test_scratch_stays_in_l2_at_the_recipe():
    """The part of the value chain's backward scratch at 5120 rows that the
    dW pass reads (a_i and g_i in bf16, ~27 MB) fits the H100's 50 MB L2."""
    p = fused_mlp.plan(PPO_CHAINS["value"], 5120, H100_SMS, backward=True)
    read = sum(b for name, b in p["scratch"] if name[0] in "ag" and not name.startswith("act"))
    assert read < 50 * 2 ** 20


def test_the_wrapper_allocates_the_plans_scratch(monkeypatch):
    """chain_bwd in bf16 mode hands the kernel one scratch of the plan's
    bytes, and the plan's launch (a fake library records the call)."""
    dims = PPO_CHAINS["policy"]
    calls = []

    class FakeLib:
        def brax_fused_mlp_bwd(self, *args):
            calls.append(args)
            return 0

    allocated = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **{k: v for k, v in kw.items() if k != "device"})
        if kw.get("dtype") == torch.uint8:
            allocated.append(t.numel())
        return t

    monkeypatch.setattr(fused_mlp, "_on_cpu", lambda *groups: False)
    monkeypatch.setattr(fused_mlp, "_check", lambda x2, ws, bs, act, extra=(): dims)
    monkeypatch.setattr(fused_mlp, "card_plan",
                        lambda d, rows, dev, bw: fused_mlp.plan(d, rows, H100_SMS, bw))
    monkeypatch.setattr(fused_mlp, "_LIBRARY", types.SimpleNamespace(get=FakeLib))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fused_mlp.torch, "empty", empty)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((300, dims[0]), generator=gen)
    ws = [torch.randn((a, b), generator=gen) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros(b) for b in dims[1:]]
    g = torch.randn((300, dims[-1]), generator=gen)
    fused_mlp.chain_bwd(x, ws, bs, g)
    p = fused_mlp.plan(dims, 300, H100_SMS, backward=True)
    assert allocated == [p["scratch_bytes"]]
    (args,) = calls
    assert args[6] == p["scratch_bytes"]
    assert args[13:20] == (p["cluster"], p["rows_per_tile"], p["x_stages"], p["clusters"],
                           p["smem"], p["dw_slices"], p["dw_rows_per_slice"])

"""The fused MLP kernels built from another `fused_mlp.cu` held against this
package's, on the card.

    python -m brax_torch.tools.fused_turns OTHER_FUSED_MLP_CU

OTHER_FUSED_MLP_CU is, for example, a parent commit's source unpacked by
`git archive` into a directory that `.gitignore` lists.  It must export the
same C interface and lay out shared memory as this package's
`fused_mlp.plan` reckons (every chain below is launched with this
package's plan).  For each PPO chain of the recipes on the card (ant's v1
and v2, humanoid's, halfcheetah's, grasp's and fetch's value and policy
chains, swish, at the row counts their training steps and evaluations
launch) both builds run the forward and the backward (dx, every dW and
db) in bf16 and f32 mode on the same inputs: the largest difference of
each output (0: the same bits), and the bf16 times replayed from a CUDA
graph of CALLS calls, in turns (other, this, this, other).  Prints a line
per chain, the card's name and power limit, both builds' ptxas reports and
a last line `RESULT {...}`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from brax_torch import cuda_build
from brax_torch.tools import probe_overhead as probe
from brax_torch.training import fused_mlp

# the PPO recipes' MLP chains (make_ppo_networks' defaults), swish: v1 ant's
# 87-wide observation and v2 ant's 27-wide one ("_v2"), humanoid's,
# halfcheetah's, grasp's and fetch's.  chip_smoke.py reads this table too
CHAINS = {"value": [87] + [256] * 5 + [1], "policy": [87] + [32] * 4 + [16],
          "value_v2": [27] + [256] * 5 + [1], "policy_v2": [27] + [32] * 4 + [16],
          "value_humanoid": [240] + [256] * 5 + [1], "policy_humanoid": [240] + [32] * 4 + [34],
          "value_halfcheetah": [18] + [256] * 5 + [1],
          "policy_halfcheetah": [18] + [32] * 4 + [12],
          "value_grasp": [132] + [256] * 5 + [1], "policy_grasp": [132] + [32] * 4 + [78],
          "value_fetch": [101] + [256] * 5 + [1], "policy_fetch": [101] + [32] * 4 + [20]}
# the rows each chain is launched at: the minibatch losses, the rollout's
# policy, the bootstrap value, an eval
ROWS = {"value": (5120, 1024), "policy": (5120, 2048, 128),
        "value_v2": (5120, 1024), "policy_v2": (5120, 2048, 128),
        "value_humanoid": (10240, 1024), "policy_humanoid": (10240, 2048, 128),
        "value_halfcheetah": (10240, 512), "policy_halfcheetah": (10240, 2048, 128),
        "value_grasp": (5120, 256), "policy_grasp": (5120, 2048, 128),
        "value_fetch": (5120, 256), "policy_fetch": (5120, 2048, 128)}
CALLS = 20


def inputs(dims, rows, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, dims[0]), generator=gen, device="cuda")
    ws = [(torch.rand((a, b), generator=gen, device="cuda") * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.randn((b,), generator=gen, device="cuda") * 0.1 for b in dims[1:]]
    g = torch.randn((rows, dims[-1]), generator=gen, device="cuda") / rows
    return x, ws, bs, g


def outputs(x, ws, bs, g, bf16):
    y = fused_mlp.chain_fwd(x, ws, bs, "swish", bf16)
    dx, dws, dbs = fused_mlp.chain_bwd(x, ws, bs, g, "swish", bf16)
    return {"y": y, "dx": dx, **{f"dW{i}": w for i, w in enumerate(dws)},
            **{f"db{i}": b for i, b in enumerate(dbs)}}


def main(argv) -> dict:
    if not torch.cuda.is_available():
        sys.exit("fused_turns needs a CUDA device; torch.cuda.is_available() is False")
    other_source = Path(argv[0]).resolve()
    card = cuda_build.card()
    print(card)
    cuda_build.build(fused_mlp.SOURCE, other_source)
    sources = {"this": fused_mlp.SOURCE, "other": other_source}
    for side, source in sources.items():
        with fused_mlp.built_from(source):
            report = fused_mlp.ptxas_report()
        print(f"{side} ({source}): " + " ".join(
            line.strip() for line in report.splitlines() if "registers" in line or "spill" in line))
    result = {"card": card, "other": str(other_source), "calls_per_graph": CALLS, "chains": {}}
    for name, dims in CHAINS.items():
        for rows in ROWS[name]:
            x, ws, bs, g = inputs(dims, rows)
            rec = result["chains"][f"{name}@{rows}"] = {}
            for mode in ("bf16", "f32"):
                got = {}
                for side, source in sources.items():
                    with fused_mlp.built_from(source):
                        got[side] = outputs(x, ws, bs, g, mode == "bf16")
                torch.cuda.synchronize()
                diff = {k: float((got["this"][k] - got["other"][k]).abs().max())
                        for k in got["this"]}
                rec[mode] = {"same_bits": not any(diff.values()), "max_abs_diff": diff}
            ms = {"other": {"fwd": [], "bwd": []}, "this": {"fwd": [], "bwd": []}}
            for side in ("other", "this", "this", "other"):
                with fused_mlp.built_from(sources[side]):
                    ms[side]["fwd"].append(probe.graph_us(
                        lambda i: fused_mlp.chain_fwd(x, ws, bs), CALLS) / 1e3)
                    ms[side]["bwd"].append(probe.graph_us(
                        lambda i: fused_mlp.chain_bwd(x, ws, bs, g), CALLS) / 1e3)
            rec["ms_bf16"] = ms
            print(f"{name}@{rows}: the same bits bf16 {rec['bf16']['same_bits']}, f32 "
                  f"{rec['f32']['same_bits']}; ms graph-replayed in turns (other, this, this, "
                  f"other) fwd {ms['other']['fwd'][0]:.4f} {ms['this']['fwd'][0]:.4f} "
                  f"{ms['this']['fwd'][1]:.4f} {ms['other']['fwd'][1]:.4f}, bwd "
                  f"{ms['other']['bwd'][0]:.4f} {ms['this']['bwd'][0]:.4f} "
                  f"{ms['this']['bwd'][1]:.4f} {ms['other']['bwd'][1]:.4f} [{card}]")
    result["same_bits"] = all(r[m]["same_bits"] for r in result["chains"].values()
                              for m in ("bf16", "f32"))
    print("RESULT " + json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])

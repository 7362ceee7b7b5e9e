"""What one kernel launch costs on the card: a probe with hand-written CUDA
kernels.

Counterpart of `tools/probe_pallas_overhead.py`, which measured the fixed
cost of a `pallas_call` on the TPU.  Its two kernel bodies are ported to
`brax_torch/csrc/probe.cu`:

- `copy_plus_one(x, blocks)`: o = x + 1 on an [8, 128] tile (`copy_k`),
  launched with one block (`trivial`) or with a grid of 10 or 40 blocks
  that all write the same tile (`gridded`).  The TPU runs grid steps one
  after another; the card runs blocks at once, so `gridN` here is the cost
  of N blocks, not of N sequential steps.
- `dot_chain(x, w, k)`: k dependent products h = bf16(h) @ bf16(w) summed
  in f32 (`chain_k`), for [512, 256] and [5120, 256] h (`dotchain`,
  `dotchain5120`).

On CPU tensors the wrappers run their plain versions; on CUDA tensors they
launch the kernel or raise.  `measure()` times every probe per launch in
two ways, the counterparts of `scan_time`:

- host: `length` launches issued back to back by the host, synchronised
  once per batch of `length`.  This is the cost of a wrapper call: its
  checks, the stream lookup, ctypes and the launch.  PyTorch's own eager
  x + 1 on the same tile (`torch.add`) is timed the same way beside it,
  the host cost of one eager PyTorch kernel;
- graph: the same `length` launches captured in one CUDA graph and
  replayed, synchronised once per replay: the card's counterpart of
  running them inside one jitted scan.  A wrapper's `launches` counts the
  calls that reached the kernel (host-issued and captured); the kernels
  the replays ran are counted apart, in its `replayed`.

The JAX tool's `fwd1`/`fwd10` changed the Pallas row tile of the fused MLP
forward.  The port's forward (`training/fused_mlp.py`) has fixed 32-row
tiles and no such knob, so both keys report the same measurement: that
forward on the value chain (87 -> 256 x 5 -> 1, bf16) at 5120 rows.  A
chain of k `torch.matmul` calls in bf16 (cuBLAS) is timed beside
`dot_chain` as a yardstick only.

    python -m brax_torch.tools.probe_overhead

prints one line `RESULT {...}` with the JAX tool's keys in microseconds
per launch (graph replay), the same keys under "host", the cuBLAS chains,
PyTorch's eager x + 1, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import time
from typing import Callable, Dict

import torch

from brax_torch import cuda_build

Tensor = torch.Tensor

SOURCE = cuda_build.CSRC / "probe.cu"
WIDTH = 256  # must equal WIDTH in probe.cu (checked at load)
TILE = (8, 128)
GRIDS = (10, 40)
CHAIN_ROWS = (512, 5120)
CHAIN_KS = (6, 24)
# the value chain of the PPO ant recipe (make_ppo_networks' defaults)
VALUE_CHAIN = [87] + [256] * 5 + [1]
FWD_ROWS = 5120
# the JAX tool's scan lengths (scan_time's length: 64, and 32 for the chains)
LENGTH, CHAIN_LENGTH, BATCHES = 64, 32, 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def copy_plus_one_plain(x: Tensor) -> Tensor:
    return x + 1.0


def dot_chain_plain(x: Tensor, w: Tensor, k: int) -> Tensor:
    """k products of h rounded to bf16 with w rounded to bf16, in f32: every
    product of two bf16 numbers is exact in f32, so this is bf16 inputs with
    f32 sums (in another order than the kernel's)."""
    wb = w.to(torch.bfloat16).float()
    h = x
    for _ in range(k):
        h = h.to(torch.bfloat16).float() @ wb
    return h


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def _setup(lib, path) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.brax_probe_copy_plus_one.argtypes = [p, p, i, i, p]
    lib.brax_probe_copy_plus_one.restype = i
    lib.brax_probe_dot_chain.argtypes = [p, p, p, i, i, p]
    lib.brax_probe_dot_chain.restype = i
    lib.brax_probe_width.argtypes, lib.brax_probe_width.restype = [], i
    lib.brax_probe_init.argtypes, lib.brax_probe_init.restype = [], i
    if lib.brax_probe_width() != WIDTH:
        raise RuntimeError(f"brax_probe_width in {path} disagrees with probe_overhead.py")
    err = lib.brax_probe_init()
    if err != 0:
        raise RuntimeError(f"brax_probe_init failed: error {err}")


_LIBRARY = cuda_build.Library(SOURCE, _setup)


def ptxas_report() -> str:
    """nvcc's ptxas output for the loaded kernels (registers, spills)."""
    return _LIBRARY.ptxas_report()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(*ts: Tensor) -> None:
    device = ts[0].device
    if device.type != "cuda" or any(t.device != device for t in ts):
        raise ValueError(f"the probe kernels need every tensor on one CUDA device, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the probe kernels take float32 tensors only")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("the probe kernels take contiguous, 16-byte aligned tensors only")


def copy_plus_one(x: Tensor, blocks: int = 1, out: Tensor | None = None) -> Tensor:
    """x + 1: the plain version on a CPU tensor; on a CUDA tensor one launch
    of `blocks` blocks, each of which writes all of `out`."""
    if x.device.type == "cpu":
        return copy_plus_one_plain(x)
    out = torch.empty_like(x) if out is None else out
    _check(x, out)
    if out.shape != x.shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, x {tuple(x.shape)}")
    err = _LIBRARY.get().brax_probe_copy_plus_one(
        x.data_ptr(), out.data_ptr(), x.numel(), blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy_plus_one kernel launch failed: error {err}")
    copy_plus_one.launches += 1
    return out


copy_plus_one.launches = 0
copy_plus_one.replayed = 0


def dot_chain(x: Tensor, w: Tensor, k: int, out: Tensor | None = None) -> Tensor:
    """k dependent products bf16(h) @ bf16(w) from h = x [n, 256], f32 out:
    the plain version on CPU tensors, one kernel launch on CUDA tensors."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return dot_chain_plain(x, w, k)
    if k < 1:
        raise ValueError(f"k = {k}: the chain needs at least one product")
    if x.dim() != 2 or x.shape[1] != WIDTH or w.shape != (WIDTH, WIDTH):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: the kernel takes "
                         f"[n, {WIDTH}] and [{WIDTH}, {WIDTH}]")
    out = torch.empty_like(x) if out is None else out
    _check(x, w, out)
    if out.shape != x.shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, x {tuple(x.shape)}")
    err = _LIBRARY.get().brax_probe_dot_chain(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], k,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dot_chain kernel launch failed: error {err}")
    dot_chain.launches += 1
    return out


dot_chain.launches = 0
dot_chain.replayed = 0


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def host_us(launch: Callable[[int], object], length: int, batches: int = BATCHES) -> float:
    """Microseconds per launch of `launch(i)`, issued by the host `length`
    at a time, with a synchronise after each batch."""
    for i in range(2):
        launch(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        for i in range(length):
            launch(i)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / batches / length * 1e6


def graph_us(launch: Callable[[int], object], length: int, batches: int = BATCHES,
             kernel: Callable | None = None) -> float:
    """Microseconds per launch of `launch(i)`, `length` of them captured in
    one CUDA graph, replayed `batches` times with a synchronise after each.

    A replay launches the captured kernels without their wrapper, so the
    wrapper's `launches` counts each captured launch once; the kernels that
    the replays ran (length per replay) are added to `kernel.replayed`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(length):
            launch(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        graph.replay()
        torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / batches / length * 1e6
    if kernel is not None:
        kernel.replayed += (batches + 1) * length
    return us


def inputs(rows: int, device="cuda"):
    """(h0, w) of a chain as the JAX tool makes them: h0 all ones, w normal
    times 0.05 (from torch's generator, not JAX's)."""
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn((WIDTH, WIDTH), generator=gen, device=device) * 0.05
    return torch.ones((rows, WIDTH), device=device), w


def value_chain():
    """x [FWD_ROWS, 87], lecun-uniform weights and zero biases of the value
    chain, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dims = VALUE_CHAIN
    x = torch.randn((FWD_ROWS, dims[0]), generator=gen, device="cuda")
    ws = [(torch.rand((a, b), generator=gen, device="cuda") * 2 - 1) * (3.0 / a) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    return x, ws, [torch.zeros(b, device="cuda") for b in dims[1:]]


def _pair(launch, length, kernel=None) -> Dict[str, float]:
    return {"host": host_us(launch, length), "graph": graph_us(launch, length, kernel=kernel)}


def measure() -> Dict[str, Dict[str, float]]:
    """{JAX tool key: {"host": us, "graph": us}} per launch, the cuBLAS
    chains under "cublas_<key>" and PyTorch's eager x + 1 on the tile under
    "torch_add_trivial_us"."""
    from brax_torch.training import fused_mlp

    r = {}
    tile = [torch.zeros(TILE, device="cuda"), torch.empty(TILE, device="cuda")]
    ping = lambda bufs, i: (bufs[i % 2], bufs[1 - i % 2])

    def copy(blocks):
        def launch(i):
            src, dst = ping(tile, i)
            copy_plus_one(src, blocks, out=dst)
        return launch

    def torch_add(i):
        # PyTorch's own eager kernel for the same x + 1: a yardstick only
        src, dst = ping(tile, i)
        torch.add(src, 1.0, out=dst)

    r["trivial_us"] = _pair(copy(1), LENGTH, copy_plus_one)
    r["torch_add_trivial_us"] = _pair(torch_add, LENGTH)
    for n in GRIDS:
        r[f"grid{n}_us"] = _pair(copy(n), LENGTH, copy_plus_one)
    for rows in CHAIN_ROWS:
        h0, w = inputs(rows)
        bufs = [h0, torch.empty_like(h0)]
        w16 = w.to(torch.bfloat16)
        h16 = h0.to(torch.bfloat16)
        for k in CHAIN_KS:
            key = f"dotchain{k}_us" if rows == 512 else f"dotchain{rows}_{k}_us"

            def chain(i, k=k):
                src, dst = ping(bufs, i)
                dot_chain(src, w, k, out=dst)

            def cublas(i, k=k):
                # k bf16 products in place of one launch: a yardstick only
                h = h16
                for _ in range(k):
                    h = torch.matmul(h, w16)

            r[key] = _pair(chain, CHAIN_LENGTH, dot_chain)
            r["cublas_" + key] = _pair(cublas, CHAIN_LENGTH)
    x, ws, bs = value_chain()
    fwd = _pair(lambda i: fused_mlp.chain_fwd(x, ws, bs, "swish", True), CHAIN_LENGTH)
    r["fwd1_us"] = r["fwd10_us"] = fwd
    return r


def result(r: Dict[str, Dict[str, float]]) -> Dict[str, object]:
    """The RESULT line: the JAX tool's keys (graph replay), the same under
    "host", the cuBLAS chains under "cublas_chain", PyTorch's eager x + 1
    under "torch_add_trivial", and the card."""
    mine = [k for k in r if not k.startswith(("cublas_", "torch_add_"))]
    return {
        **{k: r[k]["graph"] for k in mine},
        "host": {k: r[k]["host"] for k in mine},
        "cublas_chain": {k[len("cublas_"):]: r[k] for k in r if k.startswith("cublas_")},
        "torch_add_trivial": r["torch_add_trivial_us"],
        "fwd_note": "fwd1_us and fwd10_us are one measurement: the port's fused forward "
                    "has fixed 32-row tiles (value chain, 5120 rows, bf16)",
        "grid_note": "gridN launches N concurrent blocks, not N sequential grid steps",
        "card": cuda_build.card(),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_overhead needs a CUDA device; torch.cuda.is_available() is False")
    print("RESULT " + json.dumps(result(measure())))


if __name__ == "__main__":
    main()

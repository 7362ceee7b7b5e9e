"""Fused MLP chain, forward and backward: hand-written CUDA kernels and their
plain-torch versions.

Counterpart of `brax_tpu/training/fused_mlp.py`.  `dense_chain(x, kernels,
biases, activation, matmul_dtype)` computes y = act-chain(x @ W_i + b_i)
with a linear last layer, over any leading dims, as a
`torch.autograd.Function` whose forward is one launch of the forward kernel
and whose backward is one launch of the backward kernel
(`brax_torch/csrc/fused_mlp.cu`), the counterpart of the JAX `custom_vjp`.

On CPU tensors the wrappers `chain_fwd` / `chain_bwd` run their plain
versions `chain_fwd_plain` / `chain_bwd_plain`; on CUDA tensors they launch
the kernel or raise, and never fall back.  `dense_chain_plain` is the same
chain through the plain versions on any device.

In bf16 mode the kernels run as thread-block clusters over tiles of rows:
a cluster is a pipeline, each CTA holding some of the layers whole, in
bf16, in its shared memory (`plan` picks the stages, the row tile, the grid
and the scratch, and mirrors the kernel's shared-memory layout); the
backward is two launches, a rows pass and a dW pass.  f32 mode keeps one
launch forward and three backward, 32-row tiles with FFMA products.

Semantics of the matmul precision (`matmul_dtype`):
  torch.bfloat16  matmul inputs rounded to bf16 (nearest even), products
                  summed in f32: the kernel on the tensor cores; the plain
                  version rounds to bf16 and back and multiplies in f32 with
                  TF32 off, where every product of two bf16 values is exact.
  torch.float32   plain f32 products.
The backward rounds the incoming gradient and the activations to bf16 for
its matmuls, as the TPU kernel's backward does; db sums the f32 gradient.

Parity of relu chains in bf16: the kernel and the plain version round the
same values but sum in other orders, so an activation may round to a
neighbouring bf16 number and move the next pre-activation by ~1e-3; where
that crosses 0, relu' flips and the row's gradient differs by its whole
size.  relu is held in bf16 forward on every row, backward in f32 mode on
the rows whose pre-activations lie clear of 0, and backward in bf16 on
every row with dx off on no more rows than the plain version's bf16 and f32
pre-activations flip at the kink and each dW and db within the plain bf16
version's own error against f32 (tests/test_torch_cuda.py, chip_smoke.py);
swish, which has no kink, holds the same shapes in bf16 whole.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from brax_torch import cuda_build

Tensor = torch.Tensor

SOURCE = cuda_build.CSRC / "fused_mlp.cu"
# must equal MAX_WIDTH / MAX_IN_WIDTH / MAX_LAYERS / SMEM_LIMIT in fused_mlp.cu
# (checked at load).  Every layer's output is at most MAX_WIDTH wide; the
# input may be up to MAX_IN_WIDTH (SAC's critic: obs and action together)
MAX_WIDTH, MAX_IN_WIDTH, MAX_LAYERS = 256, 352, 8
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on an H100
# fused_mlp.cu's most CTAs in a cluster (pipeline stages), and its row
# tiles in the order plan() tries them
MAX_CLUSTER, ROW_TILES = 8, (64, 32, 16)
_UNFIT = 1 << 30
# its dW tile edge and rows per staged chunk (DW_TILE, DW_ROWS; f32 mode: DT, RC)
DW_TILE, DW_ROWS = 64, 64
# the dW pass's most slices of rows: a tile's last block sums them all
DW_MAX_SLICES = 8
SCRATCH_ALIGN = 256
ACTIVATIONS = {"swish": 0, "relu": 1, "tanh": 2}

_ENABLED = False


def enable(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def enabled_as(on: bool):
    """The fused kernels on or off inside the block, the previous setting
    restored after it."""
    prev = enabled()
    enable(on)
    try:
        yield
    finally:
        enable(prev)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def act_fn(name: str):
    if name == "swish":
        return lambda z: z * torch.sigmoid(z)
    if name == "relu":
        return torch.relu
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"unsupported fused activation: {name}")


def act_grad(name: str, z: Tensor) -> Tensor:
    """d act(z) / dz from the pre-activation z."""
    if name == "swish":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    if name == "relu":
        return (z > 0).to(z.dtype)
    if name == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    raise ValueError(name)


def _round(t: Tensor, bf16: bool) -> Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


def _mm(a: Tensor, b: Tensor, bf16: bool) -> Tensor:
    """a @ b with both rounded to bf16 in bf16 mode, summed in f32."""
    return _round(a, bf16) @ _round(b, bf16)


def _forward_plain(x2, kernels, biases, activation, bf16, keep):
    act = act_fn(activation)
    a, zs = [x2], []
    h = x2
    for i, (w, b) in enumerate(zip(kernels, biases)):
        z = _mm(h, w, bf16) + b
        if i < len(kernels) - 1:
            h = act(z)
            if keep:
                zs.append(z)
                a.append(h)
        else:
            h = z
    return h, a, zs


def chain_fwd_plain(x2: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                    activation: str = "swish", bf16: bool = True) -> Tensor:
    """The forward kernel's plain version: x2 [n, d0] -> y2 [n, dL]."""
    return _forward_plain(x2, kernels, biases, activation, bf16, keep=False)[0]


def chain_bwd_plain(x2: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                    g2: Tensor, activation: str = "swish", bf16: bool = True
                    ) -> Tuple[Tensor, List[Tensor], List[Tensor]]:
    """The backward kernel's plain version: recompute, then (dx, dWs, dbs)."""
    _, a, zs = _forward_plain(x2, kernels, biases, activation, bf16, keep=True)
    n = len(kernels)
    dws, dbs = [None] * n, [None] * n
    g = g2
    for i in range(n - 1, -1, -1):
        dws[i] = _mm(a[i].t(), g, bf16)
        dbs[i] = g.sum(dim=0)
        g = _mm(g, kernels[i].t(), bf16)
        if i > 0:
            g = g * act_grad(activation, zs[i - 1])
    return g, dws, dbs


# ---------------------------------------------------------------------------
# the launch plan (fused_mlp.cu's make_layout and carve, mirrored)
# ---------------------------------------------------------------------------


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def layout(dims: Sequence[int], rows: int, x_stages: int, backward: bool) -> dict:
    """fused_mlp.cu's make_layout: the pipeline's stages (the layers each CTA
    of a cluster holds, whole, as bf16 W^T [npad][kpad + 8] and f32 biases:
    the whole chain where it fits beside the tiles, else a layer per CTA)
    and the shared memory of every CTA.  The tiles: the forward's bf16
    input tile and `x_stages` f32 staging slots of x; backward also the
    reverse pass's f32 dL/da and act'(z) tiles, its bf16 g_i tile and db's
    column sums, in the same bytes.  "bytes" > SMEM_LIMIT: the chain does
    not fit at these rows."""
    kpad = [_rup(d, 16) for d in dims[:-1]]
    npad = [_rup(d, 16) for d in dims[1:]]
    kmax, nmax = max(kpad), max(npad)
    # the f32 tiles (ldr) hold dL/da_{i+1} and act'(z_i), never the input's width
    lda, ldr, ldg = kmax + 8, min(kmax, MAX_WIDTH) + 4, nmax + 8
    fwd = rows * lda * 2 + x_stages * _rup(rows * dims[0] * 4, 16)
    bwd = 2 * rows * ldr * 4 + rows * ldg * 2 + 2 * MAX_WIDTH * 4
    tiles = max(fwd, bwd) if backward else fwd
    capacity = SMEM_LIMIT - tiles - 32
    need = [n * (k + 8) * 2 + n * 4 for k, n in zip(kpad, npad)]
    if sum(need) <= capacity:  # the whole chain in one CTA
        stages, top = [(0, len(need) - 1)], sum(need)
    else:  # a layer per CTA
        stages, top = [(i, i) for i in range(len(need))], max(need)
    if top > capacity or len(stages) > MAX_CLUSTER:
        return {"bytes": _UNFIT, "stages": None}
    return {"bytes": _rup(_rup(top, 128) + tiles, 8) + 32, "stages": stages}


def scratch_parts(dims: Sequence[int], n: int, rows: int, slices: int) -> List[Tuple[str, int]]:
    """The bf16 backward's scratch, in the kernel's order (fused_mlp.cu's
    carve): a_i in bf16, act'(z_i) in f32 (every layer but the last), g_i
    in bf16, db's per-tile partial sums, the dW partials and the tickets;
    (name, bytes) before alignment to SCRATCH_ALIGN."""
    kpad = [_rup(d, 16) for d in dims[:-1]]
    npad = [_rup(d, 16) for d in dims[1:]]
    parts = [(f"a{i}", n * k * 2) for i, k in enumerate(kpad)]
    parts += [(f"act_grad{i}", n * k * 4 if i + 1 < len(npad) else 0) for i, k in enumerate(npad)]
    parts += [(f"g{i}", n * k * 2) for i, k in enumerate(npad)]
    parts.append(("db_partials", -(-n // rows) * sum(npad) * 4))
    parts.append(("dw_partials", slices * dw_tiles(dims) * DW_TILE * DW_TILE * 4))
    parts.append(("tickets", dw_tiles(dims) * 4))
    return parts


def dw_tiles(dims: Sequence[int]) -> int:
    """64x64 tiles of all the dW_i, padded to 16."""
    return sum(-(-_rup(a, 16) // DW_TILE) * -(-_rup(b, 16) // DW_TILE)
               for a, b in zip(dims[:-1], dims[1:]))


def plan(dims: Sequence[int], rows: int, sm_count: int, backward: bool = False,
         max_clusters=None) -> dict:
    """The bf16 kernels' launch for a chain of widths `dims` over `rows` rows.

    The largest row tile (64, 32, 16) at which the chain's layers fit a
    pipeline of at most MAX_CLUSTER stages (`layout`); then the row tile
    halves (down to 16): a chain in one CTA while its tiles fill at most
    half the SMs, a pipeline while it has fewer than two tiles for each
    cluster the card holds at one CTA per SM (a pipeline overlaps its
    stages only across tiles; H100 timings of each row tile chose these,
    PERF.md).  Two x staging slots where they fit.  The grid is persistent: `clusters` =
    min(tiles, max_clusters(cluster, smem)), the clusters the card runs at
    once (the CUDA runtime's count on the card; sm_count // cluster when
    None).  Backward: the dW pass's slices of rows (two blocks per SM, no
    slice under DW_ROWS rows, at most DW_MAX_SLICES) and the scratch.
    Raises NotImplementedError if no plan fits."""
    tiles = lambda m: -(-rows // m)
    stages = lambda m: len(layout(dims, m, 1, backward)["stages"])
    fitting = [m for m in ROW_TILES if layout(dims, m, 1, backward)["bytes"] <= SMEM_LIMIT]
    if not fitting:
        raise NotImplementedError(
            f"the chain {list(dims)} needs more than {SMEM_LIMIT} bytes of shared memory per CTA "
            f"in a pipeline of {MAX_CLUSTER} stages at any row tile")
    m = fitting[0]
    while m > ROW_TILES[-1] and (2 * tiles(m) <= sm_count if stages(m) == 1
                                 else tiles(m) < 2 * (sm_count // stages(m))):
        m //= 2
    x_stages = 2 if layout(dims, m, 2, backward)["bytes"] <= SMEM_LIMIT else 1
    lay = layout(dims, m, x_stages, backward)
    cluster = len(lay["stages"])
    if max_clusters is None:
        max_clusters = lambda c, s: sm_count // c
    clusters = min(tiles(m), max_clusters(cluster, lay["bytes"]))
    p = {"cluster": cluster, "layers_per_stage": lay["stages"], "rows_per_tile": m,
         "x_stages": x_stages, "tiles": tiles(m), "clusters": clusters, "grid": clusters * cluster,
         "smem": lay["bytes"], "launches": 2 if backward else 1}
    if backward:
        chunks = -(-rows // DW_ROWS)
        want = max(1, min(chunks, -(-2 * sm_count // dw_tiles(dims)), DW_MAX_SLICES))
        per = max(1, -(-chunks // want))
        slices = max(1, -(-chunks // per))
        parts = scratch_parts(dims, rows, m, slices)
        p.update(dw_tiles=dw_tiles(dims), dw_slices=slices, dw_rows_per_slice=per * DW_ROWS,
                 scratch=parts, scratch_bytes=sum(_rup(b, SCRATCH_ALIGN) for _, b in parts))
    return p


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def _declare(lib) -> None:
    """The C interface's argument and result types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.brax_fused_mlp_fwd.argtypes = [p, p, i, i, p, p, p, i, i, i, i, i, i, p]
    lib.brax_fused_mlp_fwd.restype = i
    lib.brax_fused_mlp_bwd.argtypes = [p, p, p, p, p, p, ctypes.c_size_t, i, i, p, p, p, i, i,
                                       i, i, i, i, i, i, p]
    lib.brax_fused_mlp_bwd.restype = i
    lib.brax_fused_mlp_fwd_f32.argtypes = [p, p, i, i, p, p, p, i, p]
    lib.brax_fused_mlp_fwd_f32.restype = i
    lib.brax_fused_mlp_bwd_f32.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p, p, p, i, p]
    lib.brax_fused_mlp_bwd_f32.restype = i
    lib.brax_fused_mlp_max_clusters.argtypes = [i, i, i]
    lib.brax_fused_mlp_max_clusters.restype = i


def _setup(lib, path) -> None:
    _declare(lib)
    for name, want in (("brax_fused_mlp_max_width", MAX_WIDTH),
                       ("brax_fused_mlp_max_in_width", MAX_IN_WIDTH),
                       ("brax_fused_mlp_max_layers", MAX_LAYERS),
                       ("brax_fused_mlp_smem_limit", SMEM_LIMIT)):
        getter = getattr(lib, name)
        getter.argtypes, getter.restype = [], ctypes.c_int
        if getter() != want:
            raise RuntimeError(f"{name} in {path} disagrees with fused_mlp.py")


_LIBRARY = cuda_build.Library(SOURCE, _setup)


def library() -> cuda_build.Library:
    """The kernels' library (built and loaded at first use)."""
    return _LIBRARY


def ptxas_report() -> str:
    """nvcc's ptxas output for the loaded kernels (registers, spills)."""
    return _LIBRARY.ptxas_report()


_OTHER_LIBRARIES = {}


@contextlib.contextmanager
def built_from(source):
    """The wrappers launch the kernels built from `source` inside the
    block: another fused_mlp.cu that exports the same C interface and lays
    out shared memory as `plan` reckons (a parent commit's, say, for
    `brax_torch.tools.fused_turns`).  Its limits are not checked."""
    global _LIBRARY
    prev, source = _LIBRARY, Path(source).resolve()
    if source != SOURCE.resolve():
        if source not in _OTHER_LIBRARIES:
            _OTHER_LIBRARIES[source] = cuda_build.Library(source, lambda lib, path: _declare(lib))
        _LIBRARY = _OTHER_LIBRARIES[source]
    _max_clusters.cache_clear()
    card_plan.cache_clear()
    try:
        yield
    finally:
        _LIBRARY = prev
        _max_clusters.cache_clear()
        card_plan.cache_clear()


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(x2: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
           activation: str, extra: Sequence[Tensor] = ()) -> List[int]:
    """Validates a chain for the kernel and returns its widths d_0..d_L."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported fused activation: {activation}")
    if len(kernels) != len(biases) or not kernels:
        raise ValueError(f"{len(kernels)} kernels and {len(biases)} biases")
    if len(kernels) > MAX_LAYERS:
        raise NotImplementedError(
            f"a chain of {len(kernels)} layers; the fused kernel holds {MAX_LAYERS}")
    dims = [x2.shape[1]] + [w.shape[1] for w in kernels]
    if dims[0] > MAX_IN_WIDTH:
        raise NotImplementedError(
            f"input width {dims[0]}; the fused kernel holds inputs up to {MAX_IN_WIDTH} wide")
    for d in dims[1:]:
        if d > MAX_WIDTH:
            raise NotImplementedError(
                f"width {d}; the fused kernel holds layer widths up to {MAX_WIDTH}")
    tensors = [x2, *kernels, *biases, *extra]
    device = x2.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("the fused MLP kernels need every tensor on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the fused MLP kernels take float32 tensors only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the fused MLP kernels take contiguous tensors only")
    for k, (w, b) in enumerate(zip(kernels, biases)):
        if w.shape != (dims[k], dims[k + 1]) or b.shape != (dims[k + 1],):
            raise ValueError(f"layer {k}: kernel {tuple(w.shape)}, bias {tuple(b.shape)} "
                             f"for widths {dims[k]} -> {dims[k + 1]}")
    return dims


def _ptrs(ts: Sequence[Tensor]):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _on_cpu(*groups) -> bool:
    return all(t.device.type == "cpu" for g in groups for t in g)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(kind: int, cluster: int, smem: int) -> int:
    count = _LIBRARY.get().brax_fused_mlp_max_clusters(kind, cluster, smem)
    if count < 1:
        raise RuntimeError(f"no cluster of {cluster} CTAs with {smem} bytes of shared memory "
                           f"fits the card (cudaOccupancyMaxActiveClusters: {count})")
    return count


@functools.lru_cache(maxsize=None)
def card_plan(dims: Tuple[int, ...], rows: int, device: torch.device, backward: bool) -> dict:
    """`plan` on the card: its SM count, and the clusters the CUDA runtime
    says it runs at once."""
    return plan(dims, rows, _sm_count(device), backward,
                lambda c, s: _max_clusters(int(backward), c, s))


def chain_fwd(x2: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
              activation: str = "swish", bf16: bool = True) -> Tensor:
    """x2 [n, d0] -> y2 [n, dL]: the plain version on CPU tensors, one
    launch of the forward kernel on CUDA tensors."""
    if _on_cpu([x2], kernels, biases):
        return chain_fwd_plain(x2, kernels, biases, activation, bf16)
    dims = _check(x2, kernels, biases, activation)
    n, dev = x2.shape[0], x2.device
    y2 = torch.empty((n, dims[-1]), device=dev, dtype=torch.float32)
    lib = _LIBRARY.get()
    head = (x2.data_ptr(), y2.data_ptr(), n, len(kernels), (ctypes.c_int * len(dims))(*dims),
            _ptrs(kernels), _ptrs(biases), ACTIVATIONS[activation])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        p = card_plan(tuple(dims), n, dev, False)
        err = lib.brax_fused_mlp_fwd(*head, p["cluster"], p["rows_per_tile"], p["x_stages"],
                                     p["clusters"], p["smem"], stream)
    else:
        err = lib.brax_fused_mlp_fwd_f32(*head, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp forward kernel launch failed: error {err}")
    chain_fwd.launches += 1
    return y2


chain_fwd.launches = 0


def _dw_slices(dims: Sequence[int], n: int, device: torch.device) -> int:
    """Row slices of the f32 dW pass: enough blocks (64x64 dW tiles x
    slices) for two per SM, and no slice under DW_ROWS rows."""
    tiles = sum(-(-a // DW_TILE) * -(-b // DW_TILE) for a, b in zip(dims[:-1], dims[1:]))
    return max(1, min(-(-n // DW_ROWS), -(-2 * _sm_count(device) // tiles)))


def chain_bwd(x2: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor], g2: Tensor,
              activation: str = "swish", bf16: bool = True
              ) -> Tuple[Tensor, List[Tensor], List[Tensor]]:
    """(dx, dWs, dbs) of sum(y2 * g2): the plain version on CPU tensors, one
    launch of the backward (two kernels in bf16 mode, three in f32) on CUDA
    tensors.

    The kernels' scratch is one allocation (bf16: `plan`'s parts; f32: the
    pre-activations, the per-layer gradients and the dW partial sums).
    Each output is its own, so that autograd takes the gradients over
    without a copy."""
    if _on_cpu([x2, g2], kernels, biases):
        return chain_bwd_plain(x2, kernels, biases, g2, activation, bf16)
    dims = _check(x2, kernels, biases, activation, extra=[g2])
    n, n_layers = x2.shape[0], len(kernels)
    if g2.shape != (n, dims[-1]):
        raise ValueError(f"g2 has shape {tuple(g2.shape)}, expected {(n, dims[-1])}")
    dev = x2.device
    empty = lambda *shape: torch.empty(shape, device=dev, dtype=torch.float32)
    dx = empty(n, dims[0])
    dws = [empty(*w.shape) for w in kernels]
    dbs = [empty(*b.shape) for b in biases]
    lib = _LIBRARY.get()
    chain = (n, n_layers, (ctypes.c_int * len(dims))(*dims), _ptrs(kernels), _ptrs(biases),
             ACTIVATIONS[activation])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:
        p = card_plan(tuple(dims), n, dev, True)
        scratch = torch.empty(p["scratch_bytes"], device=dev, dtype=torch.uint8)
        err = lib.brax_fused_mlp_bwd(
            x2.data_ptr(), g2.data_ptr(), dx.data_ptr(), _ptrs(dws), _ptrs(dbs),
            scratch.data_ptr(), p["scratch_bytes"], *chain, p["cluster"], p["rows_per_tile"],
            p["x_stages"], p["clusters"], p["smem"], p["dw_slices"], p["dw_rows_per_slice"],
            stream)
    else:
        slices = _dw_slices(dims, n, dev)
        n_params = sum(w.numel() + b.numel() for w, b in zip(kernels, biases))
        sizes = [n * sum(dims[1:-1]), n * sum(dims[1:]), slices * n_params]
        zbuf, gbuf, part = torch.empty(sum(sizes), device=dev).split(sizes)
        err = lib.brax_fused_mlp_bwd_f32(
            x2.data_ptr(), g2.data_ptr(), dx.data_ptr(), _ptrs(dws), _ptrs(dbs),
            zbuf.data_ptr(), gbuf.data_ptr(), part.data_ptr(), slices, *chain, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp backward kernel launch failed: error {err}")
    chain_bwd.launches += 1
    return dx, dws, dbs


chain_bwd.launches = 0


class _DenseChain(torch.autograd.Function):
    """y2 = chain(x2); the backward is one call of the backward function."""

    @staticmethod
    def forward(ctx, x2, fwd, bwd, activation, bf16, n_layers, *params):
        kernels, biases = params[:n_layers], params[n_layers:]
        ctx.save_for_backward(x2, *params)
        ctx.bwd, ctx.activation, ctx.bf16, ctx.n_layers = bwd, activation, bf16, n_layers
        return fwd(x2, kernels, biases, activation, bf16)

    @staticmethod
    def backward(ctx, g2):
        x2, *params = ctx.saved_tensors
        n = ctx.n_layers
        dx, dws, dbs = ctx.bwd(x2, params[:n], params[n:], g2.contiguous(),
                               ctx.activation, ctx.bf16)
        return (dx, None, None, None, None, None, *dws, *dbs)


def _apply(x, kernels, biases, activation, matmul_dtype, fwd, bwd) -> Tensor:
    if matmul_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"matmul_dtype {matmul_dtype}: bfloat16 or float32")
    lead, d_in = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d_in).contiguous()
    params = [w.contiguous() for w in kernels] + [b.contiguous() for b in biases]
    y2 = _DenseChain.apply(x2, fwd, bwd, activation, matmul_dtype == torch.bfloat16,
                           len(kernels), *params)
    return y2.reshape(*lead, y2.shape[-1])


def dense_chain(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                activation: str = "swish", matmul_dtype=torch.bfloat16) -> Tensor:
    """act-separated Dense chain (linear final layer), fused fwd+bwd.

    x: [..., d0]; kernels[i]: [d_i, d_{i+1}]; biases[i]: [d_{i+1}].  On CUDA
    the forward and the backward are one kernel launch each.
    """
    return _apply(x, kernels, biases, activation, matmul_dtype, chain_fwd, chain_bwd)


def dense_chain_plain(x: Tensor, kernels: Sequence[Tensor], biases: Sequence[Tensor],
                      activation: str = "swish", matmul_dtype=torch.bfloat16) -> Tensor:
    """dense_chain through the plain versions, on any device."""
    return _apply(x, kernels, biases, activation, matmul_dtype,
                  chain_fwd_plain, chain_bwd_plain)


def activation_name(fn) -> str | None:
    """Map a supported activation callable to its kernel name."""
    if fn in (F.silu, torch.nn.functional.silu):
        return "swish"
    if fn in (F.relu, torch.relu):
        return "relu"
    if fn in (torch.tanh, F.tanh):
        return "tanh"
    return None

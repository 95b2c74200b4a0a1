"""The int8 conv: s8 x s8 -> s32 implicit GEMM, three CUDA routes + plain versions.

Replaces the int8 conv of ``lstm_unet_tpu/ops/quant.py::conv2d_q`` (the XLA
conv of ``_conv_int8``, ``quant.py:91``; the JAX package wrote no Pallas
kernel for it) together with its dequant epilogue. From an int8 NHWC
activation ``xq [B,H,W,Cin]``, its f32 scale ``s_x`` (0-d), int8 weights and
their per-output-channel f32 scales ``w_scale [N]``::

    acc = SAME stride-1 conv(xq, kernel_q)          exact, int32
    y   = float32(acc) * (s_x * w_scale) [+ bias]   each op rounded in f32

then ``y`` is rounded once to ``out_dtype`` (float32 or bfloat16). With no
bias the add is skipped, as the reference skips it.

:func:`route` picks one of three kernels by shape alone, each with its own
launch count:

- ``"wgmma"`` (``csrc/conv_int8_wgmma.cu``, :func:`conv2d_int8_wgmma`,
  :data:`WGMMA_COUNT`): ``cin % 16 == 0`` and a square kernel of 1, 3 or 5.
  It takes the float activation and its scale (static, or None: dynamic)
  and folds the reference's activation quantize (:func:`quantize_act`) into
  its staging, so no int8 activation reaches device memory; with a dynamic
  scale one abs-max pass stays outside it. Weights go in packed once by
  :func:`pack_weight_wgmma`. It takes 24 of the flagship's 25 int8 sites.
  Its tile fits the site (:func:`kernel_tile_n`, :func:`kernel_chunk`):
  32- and 64-column tiles (counted apart too, :data:`WGMMA_NARROW_COUNT`)
  for cout <= 64, chunks of 64 or 32 channels where cin is not a multiple
  of 128. With the gate epilogue (:func:`conv2d_int8_wgmma_gates`,
  ``csrc/conv_int8_wgmma_gates.cu``, counted also as :data:`GATES_COUNT`)
  it is the unfused int8 ConvLSTM cell's h-conv, gate add and gate update
  in one launch, on weights packed in the gate order (:func:`gate_order`).
- ``"smallk"`` (``csrc/conv_int8_smallk.cu``, :func:`conv2d_int8_smallk`,
  :data:`SMALLK_COUNT`): the sites whose whole reduction K = KH*KW*cin,
  padded to 32, is at most :data:`SMALLK_MAX_K` and whose block fits its
  shared memory (:func:`smallk_takes`): the flagship's cin = 1 x-conv (K =
  25), the tiny model's cin 8 and 24 sites (K = 8, 72, 216), non-square
  kernels. Float activation and scale as the wgmma route; weights packed
  once by :func:`pack_weight_smallk`; the output written in full rows.
- ``"mma_sync"`` (``csrc/conv_int8.cu``, :func:`conv2d_int8`,
  :data:`COUNT`): what neither takes (a larger K with cin not a multiple of
  16, or a kernel of 7 or more with one; no site of the flagship or of the
  tiny model), on an int8 ``xq`` from :func:`quantize_act`; weights packed
  once by :func:`pack_weight`.

This module alone knows the packs: :func:`pack_site` chooses a kernel's
route and packs it for that route (in the gate order where the gate
epilogue takes it), :func:`unpack_site` gives the kernel back, and
:func:`conv2d_int8_site` runs a float activation through the route a pack
was made for; their callers keep the route beside the pack.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors. The plain versions are exact on both devices, so kernels
and plain versions are compared bit for bit: the sums by ``F.conv2d`` on
int32 tensors on the CPU, on the card by a float64 conv with cuDNN off
(every partial sum is an integer below 2^53, so any order of summation is
exact), rounded back to int32. The wgmma and small-K routes' plain versions
are :func:`quantize_act` followed by the mma_sync route's plain arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .lstm_gates import lstm_gate_update_plain

COUNT = _build.LaunchCount()         # the mma_sync route
WGMMA_COUNT = _build.LaunchCount()   # the wgmma route (quantize folded in)
WGMMA_NARROW_COUNT = _build.LaunchCount()  # of those, the 32- and 64-column tiles
GATES_COUNT = _build.LaunchCount()   # of those, the gate epilogue (an int8 ConvLSTM h-conv)
SMALLK_COUNT = _build.LaunchCount()  # the small-K route (quantize folded in)

BLOCK_N, BLOCK_K = 128, 64  # tile of csrc/conv_int8.cu: N and K padding

# csrc/conv_int8_wgmma.cu: the pack in 128-channel chunks of 8 planes of 16
# bytes; the kernel's chunks of 128, 64 or 32 channels; tiles of 2 * rows
# output rows (rows M tiles a consumer warpgroup) x 64 pixels x N columns
WG_CHUNK, WG_PLANES, WG_COLS = 128, 8, 64
WG_KERNEL_SIZES = (1, 3, 5)
WG_TILE_ROWS = {256: 1, 128: 1, 64: 2, 32: 4, 8: 1}  # rows a warpgroup per N tile
# the chunks the kernel is compiled for per N tile, widest first: full chunks
# at 256 and 128 columns; at 32 columns a full chunk of 8 rows does not fit
WG_TILE_CHUNKS = {256: (128,), 128: (128,), 64: (128, 64, 32), 32: (64, 32), 8: (128, 32)}
WG_STAGES = {256: 3, 128: 6, 64: 6, 32: 8, 8: 8}  # the weight ring's depth per N tile
WG_NARROW = (32, 64)  # the N tiles counted in WGMMA_NARROW_COUNT
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
# csrc/conv_int8_smallk.cu: K padded to the mma.sync k of 32, at most 8 k
# steps (|acc| < 2^22, which its int-to-float conversion needs); tiles of 64
# pixels of a row
SMALLK_STEP, SMALLK_MAX_K, SMALLK_TILE = 32, 256, 64


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127``, a true division rounded to nearest on every device, as the
    reference forms its scales (and the kernels theirs). PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's rounded reciprocal,
    one ulp off the division for some values."""
    return t / torch.full_like(t, 127.0)


def quantize_act(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization -> (int8 x, 0-d f32 scale on x's
    device): ``clip(round(x_f32 / s), -127, 127)``, a true division rounded
    half to even. ``scale=None`` computes it from ``x`` (``max(max|x|, 1e-8)
    / 127``, no host read); a static (calibrated) scale skips the reduction."""
    if scale is None:  # max|x| is exact in x's dtype: one pass, no f32 copy
        amax = torch.linalg.vector_norm(x, ord=float("inf")).float()
        scale = div127(torch.clamp(amax, min=1e-8))
    xf = x.float()  # a new tensor (or x itself when x is f32: not updated in place)
    xf = xf.div(scale) if xf is x else xf.div_(scale)
    return xf.round_().clamp_(-127, 127).to(torch.int8), scale


def smallk_smem_bytes(kh: int, kw: int, cin: int, cout: int, out_bytes: int = 4) -> int:
    """Shared memory one block of the small-K kernel needs (its ``layout``):
    the packed weights, the per-column scale and bias, the offset table, the
    quantized window of a 64-pixel tile (KH rows x 64 + KW - 1 pixels x cin
    bytes), the tile's A rows (K padded to 32, each row padded by 16 bytes)
    and 8 warp slices of 16 rows x 64 columns of ``out_bytes``, each row
    padded by 8 columns."""
    kp, n8 = _ceil_to(kh * kw * cin, SMALLK_STEP), _ceil_to(cout, 8)
    window = _ceil_to(kh * (SMALLK_TILE + kw - 1) * cin, 16)
    return (kp * n8 + 8 * n8 + 4 * kp + window + SMALLK_TILE * (kp + 16)
            + 8 * 16 * 72 * out_bytes)


def smallk_takes(cin: int, kh: int, kw: int, cout: int) -> bool:
    """Whether the small-K kernel takes a site: odd kernel sizes, K = KH*KW*cin
    padded to 32 at most SMALLK_MAX_K, and a block (with f32 output, the
    larger) within a Hopper block's shared memory."""
    return (kh % 2 == 1 and kw % 2 == 1
            and _ceil_to(kh * kw * cin, SMALLK_STEP) <= SMALLK_MAX_K
            and smallk_smem_bytes(kh, kw, cin, cout, 4) <= SMEM_LIMIT)


def route(h: int, w: int, cin: int, k: int, cout: int) -> Optional[str]:
    """The int8 conv kernel of a site with a square ``k`` x ``k`` kernel:
    ``"wgmma"``, ``"smallk"``, ``"mma_sync"``, or None for an empty one. Shape
    alone."""
    if min(h, w, cin, k, cout) <= 0:
        return None
    if cin % 16 == 0 and k in WG_KERNEL_SIZES:
        return "wgmma"
    if smallk_takes(cin, k, k, cout):
        return "smallk"
    return "mma_sync"


def weight_route(kernel_q: torch.Tensor) -> str:
    """The route of an OIHW kernel's site (the frame's size does not matter)."""
    n, cin, kh, kw = kernel_q.shape
    if kh == kw:
        return route(1, 1, cin, kh, n)
    return "smallk" if smallk_takes(cin, kh, kw, n) else "mma_sync"


# ---------------------------------------------------------------- mma_sync route


def pack_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 ``kernel_q [N,Cin,KH,KW]`` -> ``[N_pad, K_pad]`` int8, row n
    holding ``kernel_q[n]`` in (ky, kx, ci) order, zero padded."""
    if kernel_q.dtype != torch.int8 or kernel_q.dim() != 4:
        raise ValueError(f"pack_weight takes an OIHW int8 kernel, got "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    n, cin, kh, kw = kernel_q.shape
    kdim = kh * kw * cin
    packed = torch.zeros(_ceil_to(n, BLOCK_N), _ceil_to(kdim, BLOCK_K), dtype=torch.int8,
                         device=kernel_q.device)
    packed[:n, :kdim] = kernel_q.permute(0, 2, 3, 1).reshape(n, kdim)
    return packed


def unpack_weight(packed: torch.Tensor, n: int, cin: int, kh: int, kw: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight`: the OIHW int8 kernel (a view)."""
    return packed[:n, :kh * kw * cin].reshape(n, kh, kw, cin).permute(0, 3, 1, 2)


def conv_acc_plain(xq: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums ``[B,H,W,N]`` of the SAME conv of int8 ``xq
    [B,H,W,Cin]`` with the OIHW int8 ``kernel_q``."""
    kh, kw = kernel_q.shape[2], kernel_q.shape[3]
    pad = (kh // 2, kw // 2)
    x = xq.permute(0, 3, 1, 2)
    if xq.device.type == "cpu":
        acc = F.conv2d(x.to(torch.int32), kernel_q.to(torch.int32), padding=pad)
    else:
        with torch.backends.cudnn.flags(enabled=False):
            acc = F.conv2d(x.double(), kernel_q.double(), padding=pad)
        acc = acc.round().to(torch.int32)
    return acc.permute(0, 2, 3, 1)


def _dequant_plain(xq, s_x, kernel_q, w_scale, bias, out_dtype):
    """The exact sums, then ``acc * (s_x * w_scale) [+ bias]`` in f32, in the
    reference's order, then ``out_dtype``."""
    y = conv_acc_plain(xq, kernel_q).float() * (s_x * w_scale)
    return (y if bias is None else y + bias).to(out_dtype)


def conv2d_int8_plain(xq: torch.Tensor, s_x: torch.Tensor, packed: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int,
                      kw: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the mma_sync kernel (same arguments)."""
    COUNT.plain += 1
    kq = unpack_weight(packed, w_scale.shape[0], xq.shape[-1], kh, kw)
    return _dequant_plain(xq, s_x, kq, w_scale, bias, out_dtype)


def _present(*ts):
    return [t for t in ts if t is not None]


def _check_common(s_x, w_scale, bias, out_dtype, name) -> None:
    n = w_scale.shape[0]
    if s_x is not None and (s_x.numel() != 1 or s_x.dtype != torch.float32):
        raise TypeError(f"{name}: the scale must be a 0-d float32 tensor")
    if w_scale.dtype != torch.float32:
        raise TypeError(f"{name}: w_scale must be float32")
    if bias is not None and (bias.shape != w_scale.shape or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 [{n}]")
    if out_dtype not in _build.DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _check(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype) -> None:
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"xq must be int8 [B,H,W,Cin], got {tuple(xq.shape)} {xq.dtype}")
    n, cin = w_scale.shape[0], xq.shape[-1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"SAME conv needs odd kernel sizes, got {kh}x{kw}")
    want = (_ceil_to(n, BLOCK_N), _ceil_to(kh * kw * cin, BLOCK_K))
    if packed.dtype != torch.int8 or tuple(packed.shape) != want:
        raise ValueError(f"packed weight {tuple(packed.shape)} {packed.dtype} is not the "
                         f"pack of a {kh}x{kw} kernel, Cin={cin}, N={n}: want {want}")
    if s_x is None:
        raise TypeError("conv2d_int8: s_x is required")
    _check_common(s_x, w_scale, bias, out_dtype, "conv2d_int8")
    if len({t.device for t in _present(xq, s_x, packed, w_scale, bias)}) != 1:
        raise ValueError("xq, s_x, the weights and the bias must be on one device")


def _call(fn, x: torch.Tensor, args, name: str) -> None:
    """Call a C entry on x's device and raise on the error it reports."""
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args)
    _build.check(err, name)


def _cuda_inputs_ok(x: torch.Tensor, packed: torch.Tensor, *rest) -> None:
    if not all(t.is_contiguous() for t in _present(x, packed, *rest)):
        raise ValueError("the int8 conv kernels need contiguous inputs, weights and bias")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the int8 conv kernels need 16-byte aligned inputs and weights")


def conv2d_int8(xq: torch.Tensor, s_x: torch.Tensor, packed: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int, kw: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y [B,H,W,N]`` in ``out_dtype`` of the int8 conv described above, on
    the mma_sync route.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). ``xq`` must be contiguous and 16-byte aligned.
    """
    _check(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype)
    if xq.device.type == "cpu":
        return conv2d_int8_plain(xq, s_x, packed, w_scale, bias, kh, kw, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {xq.device}")
    _cuda_inputs_ok(xq, packed, s_x, w_scale, bias)
    b, h, w, cin = xq.shape
    n = w_scale.shape[0]
    y = torch.empty(b, h, w, n, dtype=out_dtype, device=xq.device)
    if y.numel() == 0:
        return y
    _call(_build.library().lut_conv2d_int8, xq,
          (xq.data_ptr(), packed.data_ptr(), s_x.data_ptr(), w_scale.data_ptr(),
           None if bias is None else bias.data_ptr(), y.data_ptr(), b, h, w, cin, kh, kw,
           n, packed.shape[1], _build.DTYPES[out_dtype], _build.stream_handle(xq)),
          "lut_conv2d_int8")
    COUNT.kernel += 1
    return y


# ---------------------------------------------------------------- wgmma route
#
# The weights are packed once as [N_pad/T column tiles][Cin_pad/128 chunks]
# [K, K taps][8 planes][T columns][16 channels]: stage (tile, chunk, tap) is
# one contiguous block in the no-swizzle K-major layout wgmma reads from
# shared memory (plane p of a stage holds channels 16p .. 16p + 15 of the
# chunk for T output columns). T is the pack's tile: the smallest of 8 (the
# head, N padded to wgmma's smallest s8 N), 32, 64, 128 and 256 that holds
# cout, so a narrow site computes no padded column. Padding (columns >=
# cout, channels >= cin) is zero. The kernel reads a chunk of 64 or 32
# channels as 4 or 2 consecutive planes of a stage.


def pack_tile_n(cout: int) -> int:
    """Columns of one tile of :func:`pack_weight_wgmma`'s pack."""
    for t in (8, 32, 64, 128):
        if cout <= t:
            return t
    return 256


def pack_weight_wgmma(kernel_q: torch.Tensor, tile_n: Optional[int] = None) -> torch.Tensor:
    """OIHW int8 ``kernel_q [N,Cin,K,K]`` (Cin % 16 == 0) -> the wgmma
    route's pack ``[N_pad/T, Cin_pad/128, K, K, 8, T, 16]``, in one copy.
    ``tile_n`` overrides :func:`pack_tile_n` (T), for measurements."""
    if kernel_q.dtype != torch.int8 or kernel_q.dim() != 4:
        raise ValueError(f"pack_weight_wgmma takes an OIHW int8 kernel, got "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    n, cin, kh, kw = kernel_q.shape
    if weight_route(kernel_q) != "wgmma":
        raise ValueError(f"the wgmma route takes Cin % 16 == 0 and a square 1, 3 or 5 "
                         f"kernel, got Cin={cin} {kh}x{kw}")
    t = tile_n or pack_tile_n(n)
    if t not in WG_STAGES:
        raise ValueError(f"the wgmma pack's tile is one of {tuple(WG_STAGES)}, got {t}")
    npad, cpad = _ceil_to(n, t), _ceil_to(cin, WG_CHUNK)
    w = torch.zeros(npad, kh, kw, cpad, dtype=torch.int8, device=kernel_q.device)
    w[:n, :, :, :cin] = kernel_q.permute(0, 2, 3, 1)
    w = w.reshape(npad // t, t, kh, kw, cpad // WG_CHUNK, WG_PLANES, 16)
    return w.permute(0, 4, 2, 3, 5, 1, 6).contiguous()


def unpack_weight_wgmma(packed: torch.Tensor, n: int, cin: int) -> torch.Tensor:
    """Inverse of :func:`pack_weight_wgmma`: the OIHW int8 kernel ``[n, cin,
    K, K]``."""
    tiles, chunks, kh, kw, _, t, _ = packed.shape
    w = packed.permute(0, 5, 2, 3, 1, 4, 6).reshape(tiles * t, kh, kw, chunks * WG_CHUNK)
    return w[:n, :, :, :cin].permute(0, 3, 1, 2)


def wgmma_smem_bytes(k: int, tile_n: int, x_bytes: int = 2, chunk: int = WG_CHUNK) -> int:
    """Shared memory one block of the wgmma route needs for x elements of
    ``x_bytes`` and chunks of ``chunk`` channels at an N tile (and its
    :data:`WG_TILE_ROWS`): the weight ring of the chunk's planes, two
    quantized x tiles of one chunk (each plane padded to an odd number of
    16-byte units), the raw x ring (each loader thread's items of 16
    channels in flight: 8 of bf16 or 4 of f32 beside the 96 loaders of a
    256-column tile, 3 and 1 beside the 224 of the others), the column
    tile's table of (scale, bias) pairs (8 bytes a column) and the
    mbarriers."""
    rows, planes = WG_TILE_ROWS[tile_n], chunk // 16
    plane = (((2 * rows + k - 1) * (WG_COLS + k - 1)) | 1) * 16
    stages = WG_STAGES[tile_n]
    loaders, depth = (96, 16 // x_bytes) if tile_n == 256 else (224, 6 // x_bytes)
    raw = loaders * depth * 16 * x_bytes
    return (stages * planes * tile_n * 16 + 2 * planes * plane + raw + tile_n * 8
            + (2 * stages + 4) * 8)


def kernel_tile_n(b: int, h: int, w: int, cout: int, sms: int) -> int:
    """The wgmma kernel's N tile for a frame: the pack's tile, except that a
    frame with fewer 256-column tiles than the card has SMs (the flagship's
    64^2 and 128^2 3x3 sites) takes 128-column tiles, twice as many. (The
    kernel's work items then hold :func:`group_size` column tiles each.)"""
    t = pack_tile_n(cout)
    tiles = -(-w // WG_COLS) * -(-h // (2 * WG_TILE_ROWS[t])) * b * (_ceil_to(cout, t) // t)
    return 128 if t == 256 and tiles < sms else t


def kernel_chunk(cin: int, k: int, tile_n: int, x_bytes: int = 2) -> int:
    """The wgmma kernel's chunk of input channels at an N tile: the widest
    of :data:`WG_TILE_CHUNKS` that divides cin rounded up to 32 and whose
    block fits (at 32 and 64 columns and the 8-column head: 64 channels for
    cin 192, 32 for cin 32), so no k32 product and no quantize is spent on
    padded channels past that rounding; 128, the whole chunk of the pack,
    at 128 and 256 columns and wherever cin % 128 == 0 fits."""
    c32 = _ceil_to(cin, 32)
    for chunk in WG_TILE_CHUNKS[tile_n]:
        if c32 % chunk == 0 and wgmma_smem_bytes(k, tile_n, x_bytes, chunk) <= SMEM_LIMIT:
            return chunk
    return WG_TILE_CHUNKS[tile_n][-1]


def group_size(ntiles: int, nchunks: int, nsp: int, b: int, blocks: int) -> int:
    """``csrc/conv_int8_wgmma.cuh::group_size``: the column tiles of one work
    item, of ``ntiles``. Where the input is one or two chunks they stay in
    the kernel's two x buffers while it walks the column tiles, so each x
    value is quantized once a spatial tile: the most that still gives each of
    ``blocks`` blocks a work item (``nsp * b`` spatial tiles); else 1."""
    if nchunks > 2:
        return 1
    for g in range(ntiles, 1, -1):
        if ntiles % g == 0 and nsp * b * (ntiles // g) >= blocks:
            return g
    return 1


def work_tile(t: int, nx: int, ny: int, ngroups: int, rows: int) -> Tuple[int, int, int, int]:
    """``csrc/conv_int8_wgmma.cuh::tile_at``: ``(lane, column group, y0, x0)``
    of work item ``t`` on a frame of ``nx`` x ``ny`` spatial tiles of
    ``rows`` x 64 pixels: spatial tiles fastest, then column groups, then
    lanes."""
    x0 = t % nx * WG_COLS
    t //= nx
    y0 = t % ny * rows
    t //= ny
    return t // ngroups, t % ngroups, y0, x0


def kernel_schedule(b: int, h: int, w: int, cin: int, k: int, cout: int, tile_n: int,
                    chunk: int, blocks: int):
    """The persistent grid of the wgmma kernel, block by block, as its loops
    walk it: for each of ``blocks`` blocks the list of its work items' tiles
    ``(lane, y0, x0, stages)``, with ``stages`` the weight stages ``(column
    tile, chunk, tap)`` its ring takes in, in order."""
    rows = 2 * WG_TILE_ROWS[tile_n]
    pack_tn = pack_tile_n(cout)
    nx, ny = -(-w // WG_COLS), -(-h // rows)
    nchunks = -(-cin // chunk)
    tiles_n = _ceil_to(cout, pack_tn) // tile_n
    group = group_size(tiles_n, nchunks, nx * ny, b, blocks)  # column tiles of a work item
    ngroups = tiles_n // group
    items = nx * ny * ngroups * b
    out = []
    for block in range(blocks):
        mine = []
        for t in range(block, items, blocks):
            lane, nt, y0, x0 = work_tile(t, nx, ny, ngroups, rows)
            stages = tuple((nt * group + g, ch, tap) for g in range(group)
                           for ch in range(nchunks) for tap in range(k * k))
            mine.append((lane, y0, x0, stages))
        out.append(mine)
    return out


def conv2d_int8_wgmma_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                            packed: torch.Tensor, w_scale: torch.Tensor,
                            bias: Optional[torch.Tensor], k: int,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the wgmma kernel (same arguments):
    :func:`quantize_act`, then the exact sums and the dequant."""
    WGMMA_COUNT.plain += 1
    if packed.shape[5] in WG_NARROW:
        WGMMA_NARROW_COUNT.plain += 1
    xq, s_x = quantize_act(x, scale)
    kq = unpack_weight_wgmma(packed, w_scale.shape[0], x.shape[-1])
    return _dequant_plain(xq, s_x, kq, w_scale, bias, out_dtype)


def _check_wgmma(x, scale, packed, w_scale, bias, k, out_dtype) -> None:
    if x.dim() != 4 or x.dtype not in _build.DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 [B,H,W,Cin], got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, cin = w_scale.shape[0], x.shape[-1]
    if route(1, 1, cin, k, n) != "wgmma":
        raise ValueError(f"the wgmma route takes Cin % 16 == 0 and k in {WG_KERNEL_SIZES}, "
                         f"got Cin={cin} k={k}")
    # a pack of any tile (pack_weight_wgmma's tile_n may override cout's)
    wants = {t: (_ceil_to(n, t) // t, -(-cin // WG_CHUNK), k, k, WG_PLANES, t, 16)
             for t in WG_STAGES}
    if packed.dtype != torch.int8 or tuple(packed.shape) not in wants.values():
        raise ValueError(f"packed weight {tuple(packed.shape)} {packed.dtype} is not the "
                         f"wgmma pack of a {k}x{k} kernel, Cin={cin}, N={n}: want "
                         f"{wants[pack_tile_n(n)]}")
    _check_common(scale, w_scale, bias, out_dtype, "conv2d_int8_wgmma")
    if len({t.device for t in _present(x, scale, packed, w_scale, bias)}) != 1:
        raise ValueError("x, the scale, the weights and the bias must be on one device")


def conv2d_int8_wgmma(x: torch.Tensor, scale: Optional[torch.Tensor], packed: torch.Tensor,
                      w_scale: torch.Tensor, bias: Optional[torch.Tensor], k: int,
                      out_dtype: torch.dtype = torch.float32,
                      tile_n: Optional[int] = None, chunk: Optional[int] = None
                      ) -> torch.Tensor:
    """``y [B,H,W,N]`` in ``out_dtype`` of the int8 conv of float ``x``
    (bf16 or f32) quantized with ``scale`` (0-d f32), or dynamically with
    ``scale=None``: ``quantize_act`` and the conv in one kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises). For measurements, ``tile_n`` overrides
    :func:`kernel_tile_n` (a divisor of the pack's tile) and ``chunk``
    :func:`kernel_chunk` (one of :data:`WG_TILE_CHUNKS` at that tile).
    """
    _check_wgmma(x, scale, packed, w_scale, bias, k, out_dtype)
    if x.device.type == "cpu":
        return conv2d_int8_wgmma_plain(x, scale, packed, w_scale, bias, k, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    _cuda_inputs_ok(x, packed, scale, w_scale, bias)
    b, h, w, cin = x.shape
    n = w_scale.shape[0]
    y = torch.empty(b, h, w, n, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    dynamic = scale is None
    if dynamic:  # max|x|, exact in x's dtype; the kernel forms the scale from it
        scale = torch.linalg.vector_norm(x, ord=float("inf"))
    if tile_n is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        tile_n = kernel_tile_n(b, h, w, n, sms)
    if tile_n not in WG_TILE_ROWS:
        raise ValueError(f"the wgmma kernel's N tile is one of {tuple(WG_TILE_ROWS)}, "
                         f"got {tile_n}")
    chunk = chunk or kernel_chunk(cin, k, tile_n, x.element_size())
    _call(_build.library().lut_conv2d_int8_wgmma, x,
          (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), int(dynamic),
           w_scale.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
           b, h, w, cin, k, n, packed.shape[5], tile_n, chunk, _build.DTYPES[x.dtype],
           _build.DTYPES[out_dtype], _build.stream_handle(x)),
          "lut_conv2d_int8_wgmma")
    WGMMA_COUNT.kernel += 1
    if tile_n in WG_NARROW:
        WGMMA_NARROW_COUNT.kernel += 1
    return y


# ---------------------------------------------------------------- gate epilogue
#
# The unfused int8 ConvLSTM cell's h-conv (cout = 4F, gates i | f | g | o in
# blocks of F) on the wgmma route, with the cell's gate add and K1's gate
# update as its epilogue (csrc/conv_int8_wgmma_gates.cu): only h' and c' are
# written. Its weights are packed once in K4's column order
# (csrc/convlstm_wgmma.cu, ops/kernels/convlstm_cell.py::_pack): per 16
# columns of a 256-column pack tile [i f i f i f i f | g o g o g o g o], so
# the accumulators of each consumer thread hold all four gates of 16 (at
# 256-column tiles) or 8 (at 128) consecutive features. Every 16 columns hold
# whole features, so both N tiles run over the one pack.

GATE_TILE = 256  # the gate pack's tile: all four gates of 64 features


def gate_order(n: int, device=None) -> torch.Tensor:
    """The gate pack's column order for ``n = 4F`` gate columns: entry ``col``
    is the natural output channel (``gate * F + feature``) that column
    ``col`` holds. Column ``16 n16 + r`` of pack tile ``t`` holds gate
    ``2 (r // 8) + r % 2`` of feature ``64 t + 16 ((r % 8) // 2) + n16``."""
    col = torch.arange(n, device=device)
    tile, r16 = col // GATE_TILE, col % GATE_TILE
    n16, r = r16 // 16, r16 % 16
    feat = GATE_TILE // 4 * tile + 16 * (r % 8 // 2) + n16
    return (2 * (r // 8) + r % 2) * (n // 4) + feat


def conv2d_int8_wgmma_gates_plain(h: torch.Tensor, scale: Optional[torch.Tensor],
                                  packed: torch.Tensor, w_scale: torch.Tensor,
                                  gx: torch.Tensor, c: torch.Tensor, k: int,
                                  recurrent_activation: str = "sigmoid"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the gate kernel (same arguments): the unfused
    cell's own steps, the h-conv (the wgmma route's plain version) in gx's
    dtype and in natural order, the add ``gx + r`` and K1's plain version;
    ``(h', c')``."""
    GATES_COUNT.plain += 1
    r = conv2d_int8_wgmma_plain(h, scale, packed, w_scale, None, k, gx.dtype)
    r = r.index_select(-1, torch.argsort(gate_order(w_scale.shape[0], r.device)))
    c_new, h_new = lstm_gate_update_plain(gx + r, c, recurrent_activation)
    return h_new, c_new


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _check_gates(h, scale, packed, w_scale, gx, c, k, recurrent_activation, out) -> None:
    if h.dim() != 4 or h.dtype not in _build.DTYPES:
        raise ValueError(f"h must be float32 or bfloat16 [B,H,W,F], got {tuple(h.shape)} "
                         f"{h.dtype}")
    b, hh, ww, feat = h.shape
    if c.shape != h.shape or c.dtype != h.dtype:
        raise ValueError(f"c {tuple(c.shape)} {c.dtype} must be like h {tuple(h.shape)} "
                         f"{h.dtype}")
    if gx.dtype not in _build.DTYPES or tuple(gx.shape) != (b, hh, ww, 4 * feat):
        raise ValueError(f"gx must be float32 or bfloat16 [B,H,W,4F] = "
                         f"{(b, hh, ww, 4 * feat)}, got {tuple(gx.shape)} {gx.dtype}")
    if w_scale.shape != (4 * feat,) or feat % (GATE_TILE // 4):
        raise ValueError(f"the gate epilogue takes F % {GATE_TILE // 4} == 0 and w_scale "
                         f"[4F], got F={feat} w_scale {tuple(w_scale.shape)}")
    _check_wgmma(h, scale, packed, w_scale, None, k, gx.dtype)
    if packed.shape[5] != GATE_TILE:
        raise ValueError(f"the gate pack has {GATE_TILE}-column tiles, got {packed.shape[5]}")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent_activation {recurrent_activation!r}")
    if len({t.device for t in (h, gx, c, packed)}) != 1:
        raise ValueError("h, gx, c and the weights must be on one device")
    for t in out or ():
        if (t.shape != c.shape or t.dtype != c.dtype or t.device != c.device
                or not t.is_contiguous()):
            raise ValueError(f"out {tuple(t.shape)} {t.dtype} on {t.device} is not a "
                             f"contiguous tensor like c {tuple(c.shape)} {c.dtype}")
        if any(_overlap(t, x) for x in (h, c, gx)):
            raise ValueError("out may alias no input: the kernel's other tiles still read "
                             "h's halo")
    if out is not None and _overlap(*out):
        raise ValueError("the two tensors of out overlap")


def conv2d_int8_wgmma_gates(h: torch.Tensor, scale: Optional[torch.Tensor],
                            packed: torch.Tensor, w_scale: torch.Tensor, gx: torch.Tensor,
                            c: torch.Tensor, k: int, recurrent_activation: str = "sigmoid",
                            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                            tile_n: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', c')`` of the unfused int8 ConvLSTM cell after its x-conv: the
    int8 h-conv of the state ``h [B,H,W,F]`` (quantized with ``scale``, or
    dynamically with None) on the gate pack ``packed`` (:func:`gate_order`,
    then :func:`pack_weight_wgmma`) with ``w_scale`` in the pack's column
    order, written in gx's dtype, plus ``gx [B,H,W,4F]`` (the x-conv's
    output, natural order), through the gate math with ``c [B,H,W,F]`` (h's
    dtype); ``h'`` and ``c'`` in c's dtype, into ``out`` (an ``(h, c)`` pair
    like c, aliasing no input) when given.

    CPU tensors take the plain version; CUDA tensors launch the wgmma kernel
    with the gate epilogue (any other device raises). For measurements,
    ``tile_n`` (256 or 128) overrides :func:`kernel_tile_n`.
    """
    _check_gates(h, scale, packed, w_scale, gx, c, k, recurrent_activation, out)
    if h.device.type == "cpu":
        got = conv2d_int8_wgmma_gates_plain(h, scale, packed, w_scale, gx, c, k,
                                            recurrent_activation)
        if out is None:
            return got
        for dst, src in zip(out, got):
            dst.copy_(src)
        return out
    if h.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {h.device}")
    _cuda_inputs_ok(h, packed, scale, w_scale, gx, c)
    if gx.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("the gate epilogue needs 16-byte aligned gx and c")
    b, hh, ww, feat = h.shape
    h_out, c_out = out if out is not None else (torch.empty_like(c), torch.empty_like(c))
    if h_out.numel() == 0:
        return h_out, c_out
    dynamic = scale is None
    if dynamic:  # max|h|, exact in h's dtype; the kernel forms the scale from it
        scale = torch.linalg.vector_norm(h, ord=float("inf"))
    if tile_n is None:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        tile_n = kernel_tile_n(b, hh, ww, 4 * feat, sms)
    if tile_n not in (GATE_TILE, GATE_TILE // 2):
        raise ValueError(f"the gate epilogue's N tile is {GATE_TILE} or {GATE_TILE // 2}, "
                         f"got {tile_n}")
    _call(_build.library().lut_conv2d_int8_wgmma_gates, h,
          (h.data_ptr(), packed.data_ptr(), scale.data_ptr(), int(dynamic), w_scale.data_ptr(),
           gx.data_ptr(), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k,
           tile_n, _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[gx.dtype],
           _build.DTYPES[h.dtype], _build.stream_handle(h)),
          "lut_conv2d_int8_wgmma_gates")
    WGMMA_COUNT.kernel += 1
    GATES_COUNT.kernel += 1
    return h_out, c_out


# ---------------------------------------------------------------- small-K route
#
# The weights are packed once in the mma.sync m16n8k32 B-fragment order, as
# [K_pad/32 k steps][N_pad/8 column tiles][32 lanes][8 bytes]: lane l of
# tile t holds column n = 8t + l // 4 at k = 32s + 4(l % 4) + {0..3} (bytes
# 0-3) and + 16 (bytes 4-7), k = (ky * KW + kx) * cin + ci as in
# :func:`pack_weight`. Padding (columns >= cout, k >= KH*KW*cin) is zero.


def pack_weight_smallk(kernel_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 ``kernel_q [N,Cin,KH,KW]`` of a small-K site -> the small-K
    route's pack ``[K_pad/32, N_pad/8, 32, 8]``, in one copy."""
    if kernel_q.dtype != torch.int8 or kernel_q.dim() != 4:
        raise ValueError(f"pack_weight_smallk takes an OIHW int8 kernel, got "
                         f"{tuple(kernel_q.shape)} {kernel_q.dtype}")
    n, cin, kh, kw = kernel_q.shape
    if not smallk_takes(cin, kh, kw, n):
        raise ValueError(f"the small-K route does not take Cin={cin} {kh}x{kw} N={n}: K "
                         f"padded to {SMALLK_STEP} must be at most {SMALLK_MAX_K}")
    kdim = kh * kw * cin
    kp, n8 = _ceil_to(kdim, SMALLK_STEP), _ceil_to(n, 8)
    w = torch.zeros(n8, kp, dtype=torch.int8, device=kernel_q.device)
    w[:n, :kdim] = kernel_q.permute(0, 2, 3, 1).reshape(n, kdim)
    # [tile, g, step, half, t, byte] -> [step, tile, g, t, half, byte]
    w = w.reshape(n8 // 8, 8, kp // SMALLK_STEP, 2, 4, 4).permute(2, 0, 1, 4, 3, 5)
    return w.reshape(kp // SMALLK_STEP, n8 // 8, 32, 8).contiguous()


def unpack_weight_smallk(packed: torch.Tensor, n: int, cin: int, kh: int, kw: int
                         ) -> torch.Tensor:
    """Inverse of :func:`pack_weight_smallk`: the OIHW int8 kernel."""
    steps, tiles = packed.shape[:2]
    w = packed.reshape(steps, tiles, 8, 4, 2, 4).permute(1, 2, 0, 4, 3, 5)
    w = w.reshape(tiles * 8, steps * SMALLK_STEP)
    return w[:n, :kh * kw * cin].reshape(n, kh, kw, cin).permute(0, 3, 1, 2)


def conv2d_int8_smallk_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                             packed: torch.Tensor, w_scale: torch.Tensor,
                             bias: Optional[torch.Tensor], kh: int, kw: int,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the small-K kernel (same arguments):
    :func:`quantize_act`, then the exact sums and the dequant."""
    SMALLK_COUNT.plain += 1
    xq, s_x = quantize_act(x, scale)
    kq = unpack_weight_smallk(packed, w_scale.shape[0], x.shape[-1], kh, kw)
    return _dequant_plain(xq, s_x, kq, w_scale, bias, out_dtype)


def _check_smallk(x, scale, packed, w_scale, bias, kh, kw, out_dtype) -> None:
    if x.dim() != 4 or x.dtype not in _build.DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 [B,H,W,Cin], got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, cin = w_scale.shape[0], x.shape[-1]
    if not smallk_takes(cin, kh, kw, n):
        raise ValueError(f"the small-K route does not take Cin={cin} {kh}x{kw} N={n}")
    want = (_ceil_to(kh * kw * cin, SMALLK_STEP) // SMALLK_STEP, _ceil_to(n, 8) // 8, 32, 8)
    if packed.dtype != torch.int8 or tuple(packed.shape) != want:
        raise ValueError(f"packed weight {tuple(packed.shape)} {packed.dtype} is not the "
                         f"small-K pack of a {kh}x{kw} kernel, Cin={cin}, N={n}: want {want}")
    _check_common(scale, w_scale, bias, out_dtype, "conv2d_int8_smallk")
    if len({t.device for t in _present(x, scale, packed, w_scale, bias)}) != 1:
        raise ValueError("x, the scale, the weights and the bias must be on one device")


def conv2d_int8_smallk(x: torch.Tensor, scale: Optional[torch.Tensor], packed: torch.Tensor,
                       w_scale: torch.Tensor, bias: Optional[torch.Tensor], kh: int, kw: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y [B,H,W,N]`` in ``out_dtype`` of the int8 conv of float ``x``
    (bf16 or f32) quantized with ``scale`` (0-d f32), or dynamically with
    ``scale=None``, on the small-K route: ``quantize_act`` and the conv in
    one kernel.

    CPU tensors take the plain version; CUDA tensors launch the kernel (any
    other device raises).
    """
    _check_smallk(x, scale, packed, w_scale, bias, kh, kw, out_dtype)
    if x.device.type == "cpu":
        return conv2d_int8_smallk_plain(x, scale, packed, w_scale, bias, kh, kw, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    _cuda_inputs_ok(x, packed, scale, w_scale, bias)
    b, h, w, cin = x.shape
    n = w_scale.shape[0]
    y = torch.empty(b, h, w, n, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    dynamic = scale is None
    if dynamic:  # max|x|, exact in x's dtype; the kernel forms the scale from it
        scale = torch.linalg.vector_norm(x, ord=float("inf"))
    _call(_build.library().lut_conv2d_int8_smallk, x,
          (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), int(dynamic),
           w_scale.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
           b, h, w, cin, kh, kw, n, _build.DTYPES[x.dtype], _build.DTYPES[out_dtype],
           _build.stream_handle(x)),
          "lut_conv2d_int8_smallk")
    SMALLK_COUNT.kernel += 1
    return y


# ---------------------------------------------------------------- a site's pack

_PACKS = {"wgmma": pack_weight_wgmma, "smallk": pack_weight_smallk, "mma_sync": pack_weight}


def pack_site(kernel_q: torch.Tensor, gates: bool = False
              ) -> Tuple[str, torch.Tensor, Optional[torch.Tensor]]:
    """OIHW int8 ``kernel_q`` -> ``(route, pack, order)``: its site's route
    (:func:`weight_route`) and the pack that route's kernel reads. An h-conv
    (``gates``) that the gate epilogue takes (the wgmma route and 4F a
    multiple of :data:`GATE_TILE`: F % 64 == 0, all four flagship levels, not
    the tiny model's F = 8 and 16) is packed with its output channels in
    :func:`gate_order`, returned as ``order``; else ``order`` is None."""
    which = weight_route(kernel_q)
    order = None
    if gates and which == "wgmma" and kernel_q.shape[0] % GATE_TILE == 0:
        order = gate_order(kernel_q.shape[0], kernel_q.device)
        kernel_q = kernel_q[order]
    return which, _PACKS[which](kernel_q), order


def unpack_site(which: str, packed: torch.Tensor, shape: Tuple[int, int, int, int]
                ) -> torch.Tensor:
    """Inverse of :func:`pack_site`'s pack for route ``which``: the OIHW int8
    kernel of ``shape`` (cout, cin, kh, kw), in the pack's column order."""
    n, cin, kh, kw = shape
    if which == "wgmma":
        return unpack_weight_wgmma(packed, n, cin)
    if which == "smallk":
        return unpack_weight_smallk(packed, n, cin, kh, kw)
    return unpack_weight(packed, n, cin, kh, kw)


def conv2d_int8_site(which: str, x: torch.Tensor, scale: Optional[torch.Tensor],
                     packed: torch.Tensor, w_scale: torch.Tensor,
                     bias: Optional[torch.Tensor], kh: int, kw: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y [B,H,W,N]`` of the int8 conv of float ``x`` (quantized with
    ``scale``, or dynamically with None) on route ``which``, on its pack
    from :func:`pack_site`. The wgmma and small-K kernels quantize x as they
    stage it; the mma_sync route runs :func:`quantize_act` first."""
    if which == "wgmma":
        return conv2d_int8_wgmma(x, scale, packed, w_scale, bias, kh, out_dtype)
    if which == "smallk":
        return conv2d_int8_smallk(x, scale, packed, w_scale, bias, kh, kw, out_dtype)
    qx, s_x = quantize_act(x, scale)
    return conv2d_int8(qx, s_x, packed, w_scale, bias, kh, kw, out_dtype)

"""K4 — fused ConvLSTM level, inference (four CUDA routes + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level``.
From ``gx [B,H,W,4F]`` (x-conv + bias, computed outside), ``h, c [B,H,W,F]``
and ``wh [K,K,F,4F]``: the KxK SAME recurrent conv of ``h`` (rounded to wh's
dtype) with f32 accumulation, plus ``gx``, then the K1 gate math. Only
``h'`` and ``c'`` are written; the 4F gates never reach device memory.
Returns ``(h', c')`` — the reverse of K1's ``(c', h')`` — in h's and c's
dtypes.

The TPU kernel's limits (B = 1, F and W multiples of 128, H of 4, 5x5 only,
its VMEM budget) were the TPU's. On the card :func:`route` picks one of three
kernels by dtype and shape, each with its own launch count:

- ``"wgmma"`` (``csrc/convlstm_wgmma.cu``, :data:`WGMMA_COUNT`): bf16 compute
  (state bf16 or f32), ``F % 64 == 0``, K in {1, 3, 5}, any B, H, W. An
  implicit GEMM on the tensor cores with the gate math as its epilogue; Wh
  goes in packed (:func:`pack_wh`). It takes every ConvLSTM level of the
  flagship model.
- ``"tf32x3"`` (the same kernel on f32 operands, :data:`TF32X3_COUNT`): f32
  compute under the same limits. The tensor cores have no f32 mode, and one
  TF32 product misses the 2e-5 tolerance, so h and Wh are each split into
  hi = tf32(x) and lo = tf32(x - hi) and every product is taken as
  hi*lo + lo*hi + hi*hi (3xTF32, f32-grade sums); Wh goes in packed as hi
  and lo (:func:`pack_wh_tf32x3`). It takes every flagship level in f32.
- ``"narrow"`` (``csrc/convlstm_narrow.cu``, :data:`NARROW_COUNT`): the
  other levels with F % 8 == 0 and K in {1, 3, 5, 7}, bf16 or f32 (as
  3xTF32): the tiny model's F = 8 and 16, F = 24, 32, 96, and 7x7 levels.
  The same implicit GEMM on tiles of 32, 16 or 8 features
  (:func:`narrow_tile`) and input-channel chunks of the instruction's k;
  Wh goes in packed (:func:`pack_wh_narrow`, :func:`pack_wh_narrow_tf32x3`;
  the cells make the pack once and keep it).

A level no route takes (F % 8 != 0, K > 7, a dtype but f32 and bf16) raises
on every device; the cells check :func:`supported` and run it unfused.

Inference only, as the reference (which defines no VJP for it): with grad
mode on and any input requiring grad the wrapper raises, on every device,
rather than return outputs that carry no gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .lstm_gates import gate_math

# K4's (h', c') outputs given by the caller, or None
Carry = Optional[Tuple[torch.Tensor, torch.Tensor]]

WGMMA_COUNT = _build.LaunchCount()   # the bf16 tensor-core route
TF32X3_COUNT = _build.LaunchCount()  # the f32 tensor-core route (3xTF32)
NARROW_COUNT = _build.LaunchCount()  # the narrow-level tensor-core route

SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

# block geometry of csrc/convlstm_wgmma.cu (tensor-core route): tiles of 2
# rows x 64 pixels x 64 features (256 gate columns), 64-channel chunks, a
# 3-stage Wh ring
TC_ROWS, TC_COLS, TC_FEAT, TC_CHUNK, TC_STAGES = 2, 64, 64, 64, 3
TC_KERNEL_SIZES = (1, 3, 5)
# the 3xTF32 route: tiles of 2 rows x 64 pixels x 32 features (128 gate
# columns), 16-channel chunks, each h tile and Wh stage as hi and lo planes of
# 4 f32 channels, a 6-stage Wh ring
TF32_FEAT, TF32_CHUNK, TF32_STAGES = 32, 16, 6
# csrc/convlstm_narrow.cu: tiles of R rows (bf16 4: two M tiles a consumer
# warpgroup; 3xTF32 2) x 64 pixels x FT features (32, 16 or 8), input-channel
# chunks of the instruction's k (bf16 16 in 2 planes, 3xTF32 8 in 2 planes
# of hi and 2 of lo), a Wh ring of up to 4 stages of one kernel row each
NARROW_KERNEL_SIZES = (1, 3, 5, 7)
NARROW_FEATS = (32, 16, 8)
NARROW_CHUNK = {torch.bfloat16: 16, torch.float32: 8}
NARROW_PLANES = {torch.bfloat16: 2, torch.float32: 4}
NARROW_ROWS = {torch.bfloat16: 4, torch.float32: 2}
NARROW_STAGES = 4


def wgmma_smem_bytes(k: int) -> int:
    """Shared memory one tensor-core block needs: the Wh ring, two bf16 h
    tiles of one chunk (each channel group padded to an odd number of 16-byte
    units) and 12 mbarriers."""
    plane = (((TC_ROWS + k - 1) * (TC_COLS + k - 1)) | 1) * 16
    return (TC_STAGES * TC_CHUNK * 4 * TC_FEAT * 2 + 2 * (TC_CHUNK // 8) * plane
            + (2 * TC_STAGES + 4) * 8)


def tf32x3_smem_bytes(k: int) -> int:
    """Shared memory one 3xTF32 block needs: the Wh ring (hi and lo), two h
    tiles of one 16-channel chunk as hi and lo planes (each padded as in
    :func:`wgmma_smem_bytes`) and 16 mbarriers."""
    plane = (((TC_ROWS + k - 1) * (TC_COLS + k - 1)) | 1) * 16
    return (TF32_STAGES * 2 * TF32_CHUNK * 4 * TF32_FEAT * 4
            + 2 * 2 * (TF32_CHUNK // 4) * plane + (2 * TF32_STAGES + 4) * 8)


def narrow_tile(feat: int) -> int:
    """Features of one tile of the narrow route: the largest of 32, 16, 8
    that divides F."""
    return next(t for t in NARROW_FEATS if feat % t == 0)


def narrow_smem_bytes(k: int, tile: int, dtype: torch.dtype) -> int:
    """Shared memory one narrow-route block needs: a ring of S stages (the K
    taps of one kernel row of one chunk, 4 * tile columns, 16 bytes a plane
    entry), S the largest of 4 .. 1 that fits, two h tiles of one chunk
    (NARROW_ROWS + K - 1 rows, each plane padded to an odd number of 16-byte
    units) and 12 mbarriers."""
    planes = NARROW_PLANES[dtype]
    aplane = (((NARROW_ROWS[dtype] + k - 1) * (TC_COLS + k - 1)) | 1) * 16
    fixed = 2 * planes * aplane + (2 * NARROW_STAGES + 4) * 8
    stage = k * planes * 4 * tile * 16
    stages = NARROW_STAGES
    while stages > 1 and stages * stage + fixed > SMEM_LIMIT:
        stages -= 1
    return stages * stage + fixed


def route(h: int, w: int, feat: int, k: int, batch: int,
          dtype: torch.dtype = torch.float32) -> Optional[str]:
    """The K4 kernel that takes a level of a square ``k`` x ``k`` kernel in
    compute ``dtype``: ``"wgmma"``, ``"tf32x3"``, ``"narrow"``, or None."""
    if min(h, w, feat, batch) <= 0 or dtype not in _build.DTYPES:
        return None
    if k in TC_KERNEL_SIZES and feat % TC_FEAT == 0:
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    if (k in NARROW_KERNEL_SIZES and feat % 8 == 0
            and narrow_smem_bytes(k, narrow_tile(feat), dtype) <= SMEM_LIMIT):
        return "narrow"
    return None


def supported(h: int, w: int, feat: int, kh: int, kw: int, batch: int,
              dtype: torch.dtype = torch.float32) -> bool:
    """Whether a fused kernel takes this level in compute ``dtype`` (else the
    cell runs the plain conv + K1)."""
    return kh == kw and route(h, w, feat, kh, batch, dtype) is not None


_COUNTS = {"wgmma": WGMMA_COUNT, "tf32x3": TF32X3_COUNT, "narrow": NARROW_COUNT}


# ---------------------------------------------------------------- Wh pack
#
# The tensor-core kernel reads Wh as [F/T column tiles][F/chunk chunks][K*K
# taps] tiles, each in the no-swizzle K-major layout wgmma reads from shared
# memory: bf16, T = 64 features and 64-channel chunks of [8 channel
# groups][256 columns][8 channels] (32 KB); 3xTF32, T = 32 and 16-channel
# chunks of [hi, lo][4 channel groups][128 columns][4 channels] (16 KB).
# With t = T // 4 features per thread, column n of a tile (n16 = n // 16,
# r = n % 16) holds gate 2 * (r // 8) + r % 2 of feature
# T * tile + t * ((r % 8) // 2) + n16: per 16 columns
# [i f i f i f i f | g o g o g o g o], so one thread's accumulator fragment
# holds i, f, g and o of the same t features. _pack_dims splits
# wh [K*K, F, 4F] into (tap, chunk, group, channel, gate // 2, gate % 2,
# tile, feature // t % 4, feature % t).
_PACK_PERM = (6, 1, 0, 2, 8, 4, 7, 5, 3)
_UNPACK_PERM = tuple(sorted(range(9), key=_PACK_PERM.__getitem__))


def _pack_dims(k: int, feat: int, tile: int, chunk: int, vec: int):
    return (k * k, feat // chunk, chunk // vec, vec, 2, 2, feat // tile, 4, tile // 4)


def _pack(wh: torch.Tensor, tile: int, chunk: int, vec: int) -> torch.Tensor:
    """``wh [K,K,F,4F]`` -> ``[F/tile, F/chunk, K*K, chunk/vec, 4 tile, vec]``."""
    k, _, feat, _ = wh.shape
    if feat % TC_FEAT:
        raise ValueError(f"the packed Wh needs F % {TC_FEAT} == 0, got F={feat}")
    t = wh.reshape(_pack_dims(k, feat, tile, chunk, vec)).permute(_PACK_PERM)
    return t.reshape(feat // tile, feat // chunk, k * k, chunk // vec, 4 * tile, vec)


def _unpack(packed: torch.Tensor, tile: int, chunk: int, vec: int) -> torch.Tensor:
    kk, feat = packed.shape[2], packed.shape[0] * tile
    k = round(kk ** 0.5)
    dims = [_pack_dims(k, feat, tile, chunk, vec)[p] for p in _PACK_PERM]
    t = packed.reshape(dims).permute(_UNPACK_PERM)
    return t.reshape(k, k, feat, 4 * feat).contiguous()


def pack_wh(wh: torch.Tensor) -> torch.Tensor:
    """``wh [K,K,F,4F]`` (any strides) -> the bf16 kernel's packed
    ``[F/64, F/64, K*K, 8, 256, 8]``, in one copy."""
    return _pack(wh, TC_FEAT, TC_CHUNK, 8).contiguous()


def unpack_wh(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_wh`: ``[K,K,F,4F]``."""
    return _unpack(packed, TC_FEAT, TC_CHUNK, 8)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: by the bit pattern."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_wh_tf32x3(wh: torch.Tensor) -> torch.Tensor:
    """``wh [K,K,F,4F]`` f32 (any strides) -> the 3xTF32 kernel's packed
    ``[F/32, F/16, K*K, 2, 4, 128, 4]``: index 0 of the hi/lo axis holds
    hi = tf32(wh), index 1 lo = tf32(wh - hi)."""
    if wh.dtype != torch.float32:
        raise ValueError(f"the 3xTF32 pack takes float32 Wh, got {wh.dtype}")
    t = _pack(wh, TF32_FEAT, TF32_CHUNK, 4)
    hi = round_tf32(t)
    return torch.stack((hi, round_tf32(t - hi)), dim=3)


def unpack_wh_tf32x3(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_wh_tf32x3`: ``(hi, lo)``, each ``[K,K,F,4F]``."""
    return (_unpack(packed[:, :, :, 0], TF32_FEAT, TF32_CHUNK, 4),
            _unpack(packed[:, :, :, 1], TF32_FEAT, TF32_CHUNK, 4))


# The narrow route's packs: the same column order over tiles of T = 32, 16 or
# 8 features (:func:`narrow_tile`), input channels in chunks of 16 (bf16) or
# 8 (3xTF32), F padded with zero channels to a whole chunk:
# [F/T tiles][F_pad/chunk chunks][K*K taps][chunk/vec groups][4T columns]
# [vec], hi and lo in a stage of their own axis for 3xTF32. A kernel row's K
# taps of one chunk are one contiguous stage.


def _pack_narrow(wh: torch.Tensor, dtype: torch.dtype, vec: int) -> torch.Tensor:
    k, _, feat, _ = wh.shape
    if feat % 8:
        raise ValueError(f"the narrow route's Wh pack needs F % 8 == 0, got F={feat}")
    tile, chunk = narrow_tile(feat), NARROW_CHUNK[dtype]
    fin = -(-feat // chunk) * chunk
    if fin != feat:  # zero input channels up to a whole chunk
        wh = F.pad(wh, (0, 0, 0, fin - feat))
    dims = (k * k, fin // chunk, chunk // vec, vec, 2, 2, feat // tile, 4, tile // 4)
    t = wh.reshape(dims).permute(_PACK_PERM)
    return t.reshape(feat // tile, fin // chunk, k * k, chunk // vec, 4 * tile, vec)


def _unpack_narrow(packed: torch.Tensor, dtype: torch.dtype, vec: int) -> torch.Tensor:
    tiles, chunks, kk = packed.shape[:3]
    tile, chunk = packed.shape[-2] // 4, NARROW_CHUNK[dtype]
    feat, fin, k = tiles * tile, chunks * chunk, round(kk ** 0.5)
    dims = (k * k, fin // chunk, chunk // vec, vec, 2, 2, feat // tile, 4, tile // 4)
    t = packed.reshape([dims[p] for p in _PACK_PERM]).permute(_UNPACK_PERM)
    return t.reshape(k, k, fin, 4 * feat)[:, :, :feat].contiguous()


def pack_wh_narrow(wh: torch.Tensor) -> torch.Tensor:
    """``wh [K,K,F,4F]`` (any strides, F % 8 == 0) -> the narrow bf16
    kernel's packed ``[F/T, ceil(F/16), K*K, 2, 4T, 8]``, in one copy."""
    return _pack_narrow(wh, torch.bfloat16, 8).contiguous()


def unpack_wh_narrow(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_wh_narrow`: ``[K,K,F,4F]``."""
    return _unpack_narrow(packed, torch.bfloat16, 8)


def pack_wh_narrow_tf32x3(wh: torch.Tensor) -> torch.Tensor:
    """``wh [K,K,F,4F]`` f32 (any strides, F % 8 == 0) -> the narrow 3xTF32
    kernel's packed ``[F/T, F/8, K*K, 2, 2, 4T, 4]``: index 0 of the hi/lo
    axis holds hi = tf32(wh), index 1 lo = tf32(wh - hi)."""
    if wh.dtype != torch.float32:
        raise ValueError(f"the 3xTF32 pack takes float32 Wh, got {wh.dtype}")
    t = _pack_narrow(wh, torch.float32, 4)
    hi = round_tf32(t)
    return torch.stack((hi, round_tf32(t - hi)), dim=3)


def unpack_wh_narrow_tf32x3(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_wh_narrow_tf32x3`: ``(hi, lo)``, each ``[K,K,F,4F]``."""
    return tuple(_unpack_narrow(packed[:, :, :, i], torch.float32, 4) for i in (0, 1))


def pack_for_route(wh: torch.Tensor, which: Optional[str]) -> Optional[torch.Tensor]:
    """The pack of Wh that route ``which`` launches on, for a caller that
    keeps it across calls; None for the routes that pack per call."""
    if which != "narrow":
        return None
    if wh.dtype == torch.float32:
        return pack_wh_narrow_tf32x3(wh)
    return pack_wh_narrow(wh)


# ---------------------------------------------------------------- versions


def fused_convlstm_level_plain(gx: torch.Tensor, h: torch.Tensor,
                               c: torch.Tensor, wh: torch.Tensor,
                               recurrent_activation: str = "sigmoid"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of every route: the recurrent conv in f32 on the
    h rounded to wh's dtype (exact products, f32 sums, which the 3xTF32
    route matches to ~2^-21 relative per product), then the gate math.
    Counted on the route the wrapper takes (at a level no route takes, on
    none)."""
    b, hh, ww, feat = h.shape
    k = wh.shape[0]
    count = _COUNTS.get(route(hh, ww, feat, k, b, gx.dtype))
    if count is not None:
        count.plain += 1
    hx = h.to(wh.dtype).float().permute(0, 3, 1, 2)
    acc = F.conv2d(hx, wh.float().permute(3, 2, 0, 1), padding=k // 2)
    z = acc.permute(0, 2, 3, 1) + gx.float()
    c_new, h_new = gate_math(z[..., :feat], z[..., feat:2 * feat],
                             z[..., 2 * feat:3 * feat], z[..., 3 * feat:],
                             c.float(), recurrent_activation)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def fused_convlstm_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                         wh: torch.Tensor, recurrent_activation: str = "sigmoid",
                         packed: Optional[torch.Tensor] = None, out: Carry = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', c')`` of one ConvLSTM level, layouts as in the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel that
    :func:`route` names (any other device raises). ``gx`` and ``wh`` share
    the compute dtype, ``h`` and ``c`` the state dtype, each float32 or
    bfloat16. ``gx``, ``h`` and ``c`` are contiguous; ``wh`` may be a view
    (it is packed here, unless ``packed`` holds its :func:`pack_for_route`
    pack, which the narrow route then takes). A level :func:`route` refuses
    raises, on the CPU too.
    ``out``: two contiguous tensors like ``h`` and ``c``, aliasing no input,
    that receive ``(h', c')`` and are returned (the streaming step's
    buffers, ``engine/graph.py``).
    """
    if gx.dim() != 4 or h.dim() != 4 or wh.dim() != 4:
        raise ValueError("need gx [B,H,W,4F], h and c [B,H,W,F], wh [K,K,F,4F]")
    b, hh, ww, feat = h.shape
    k = wh.shape[0]
    if (c.shape != h.shape or gx.shape != (b, hh, ww, 4 * feat)
            or wh.shape != (k, k, feat, 4 * feat)):
        raise ValueError(f"shape mismatch: gx {tuple(gx.shape)}, h "
                         f"{tuple(h.shape)}, c {tuple(c.shape)}, wh "
                         f"{tuple(wh.shape)}")
    if len({gx.device, h.device, c.device, wh.device}) != 1:
        raise ValueError("gx, h, c and wh must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (gx, h, c, wh)):
        raise RuntimeError(
            "fused_convlstm_level is inference-only (no backward, as in the "
            "reference): run it under torch.no_grad()/inference_mode, or train "
            "with fused_cell=False")
    which = route(hh, ww, feat, k, b, gx.dtype)
    if which is None:
        raise ValueError(f"fused ConvLSTM kernel does not take {k}x{k}, F={feat}, "
                         f"B={b}, {gx.dtype}; check supported() first")
    if h.device.type == "cpu":
        got = fused_convlstm_level_plain(gx, h, c, wh, recurrent_activation)
        if out is None:
            return got
        for dst, src in zip(_outputs(h, c, out), got):
            dst.copy_(src)
        return out
    if h.device.type != "cuda":
        raise ValueError(f"no fused ConvLSTM kernel for device {h.device}")
    if gx.dtype != wh.dtype or h.dtype != c.dtype or h.dtype not in _build.DTYPES:
        raise TypeError(f"fused ConvLSTM kernel takes float32/bfloat16 with "
                        f"gx/wh and h/c dtypes equal, got gx {gx.dtype}, wh "
                        f"{wh.dtype}, h {h.dtype}, c {c.dtype}")
    if not all(t.is_contiguous() for t in (gx, h, c)):
        raise ValueError("fused ConvLSTM kernel needs contiguous gx, h and c")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent activation {recurrent_activation!r}")
    if which == "wgmma":
        return wgmma_level(gx, h, c, pack_wh(wh), k, recurrent_activation, out)
    if which == "tf32x3":
        return tf32x3_level(gx, h, c, pack_wh_tf32x3(wh), k, recurrent_activation, out)
    if packed is None:
        packed = pack_for_route(wh, which)
    return narrow_level(gx, h, c, packed, k, recurrent_activation, out)


def _outputs(h: torch.Tensor, c: torch.Tensor, out: Carry) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out`` checked as contiguous tensors like ``h`` and ``c``, or two
    new ones."""
    if out is None:
        return torch.empty_like(h), torch.empty_like(c)
    for t, like in zip(out, (h, c)):
        if (t.shape != like.shape or t.dtype != like.dtype or t.device != like.device
                or not t.is_contiguous()):
            raise ValueError(f"out {tuple(t.shape)} {t.dtype} on {t.device} is not a "
                             f"contiguous tensor like {tuple(like.shape)} {like.dtype}")
    return out


def _tensor_core_level(entry: str, count: _build.LaunchCount, want, dtype: torch.dtype,
                       gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                       packed: torch.Tensor, k: int, recurrent_activation: str, out: Carry
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, hh, ww, feat = h.shape
    if packed.shape != want or packed.dtype != dtype:
        raise ValueError(f"packed Wh {tuple(packed.shape)} {packed.dtype} is not "
                         f"the {dtype} pack for {k}x{k}, F={feat}")
    if any(t.data_ptr() % 16 for t in (gx, h, c, *(out or ()))):
        raise ValueError("the tensor-core K4 needs 16-byte aligned gx, h, c and outputs")
    h_out, c_out = _outputs(h, c, out)
    with torch.cuda.device(h.device):
        err = getattr(_build.library(), entry)(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), packed.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k,
            _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[h.dtype],
            _build.stream_handle(h))
    _build.check(err, entry)
    count.kernel += 1
    return h_out, c_out


def wgmma_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                packed: torch.Tensor, k: int, recurrent_activation: str = "sigmoid",
                out: Carry = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 tensor-core launch on Wh already packed by :func:`pack_wh`,
    for CUDA tensors that :func:`fused_convlstm_level` has checked (it packs
    per call; this entry lets a caller time the kernel without the pack)."""
    feat = h.shape[-1]
    want = (feat // TC_FEAT, feat // TC_CHUNK, k * k, TC_CHUNK // 8, 4 * TC_FEAT, 8)
    return _tensor_core_level("lut_convlstm_level_wgmma", WGMMA_COUNT, want,
                              torch.bfloat16, gx, h, c, packed, k, recurrent_activation, out)


def tf32x3_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                 packed: torch.Tensor, k: int, recurrent_activation: str = "sigmoid",
                 out: Carry = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 launch on Wh already packed by :func:`pack_wh_tf32x3`, as
    :func:`wgmma_level` is for bf16."""
    feat = h.shape[-1]
    want = (feat // TF32_FEAT, feat // TF32_CHUNK, k * k, 2, TF32_CHUNK // 4, 4 * TF32_FEAT, 4)
    return _tensor_core_level("lut_convlstm_level_tf32x3", TF32X3_COUNT, want,
                              torch.float32, gx, h, c, packed, k, recurrent_activation, out)


def narrow_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                 packed: torch.Tensor, k: int, recurrent_activation: str = "sigmoid",
                 out: Carry = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The narrow route's launch on Wh packed by :func:`pack_wh_narrow` (bf16
    compute) or :func:`pack_wh_narrow_tf32x3` (f32), for CUDA tensors that
    :func:`fused_convlstm_level` has checked (this entry also lets a caller
    time the kernel without the pack)."""
    b, hh, ww, feat = h.shape
    dt = gx.dtype
    tile, chunk = narrow_tile(feat), NARROW_CHUNK[dt]
    nchunks = -(-feat // chunk)
    if dt == torch.bfloat16:
        want = (feat // tile, nchunks, k * k, chunk // 8, 4 * tile, 8)
    else:
        want = (feat // tile, nchunks, k * k, 2, chunk // 4, 4 * tile, 4)
    if tuple(packed.shape) != want or packed.dtype != dt or not packed.is_contiguous():
        raise ValueError(f"packed Wh {tuple(packed.shape)} {packed.dtype} is not the "
                         f"narrow {dt} pack for {k}x{k}, F={feat}: want {want}")
    if any(t.data_ptr() % 16 for t in (gx, h, c, packed, *(out or ()))):
        raise ValueError("the narrow K4 needs 16-byte aligned gx, h, c, packed Wh and "
                         "outputs")
    h_out, c_out = _outputs(h, c, out)
    with torch.cuda.device(h.device):
        err = _build.library().lut_convlstm_level_narrow(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), packed.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k, tile,
            _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[dt],
            _build.DTYPES[h.dtype], _build.stream_handle(h))
    _build.check(err, "lut_convlstm_level_narrow")
    NARROW_COUNT.kernel += 1
    return h_out, c_out

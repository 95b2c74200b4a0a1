"""K4 — fused ConvLSTM level, inference (two CUDA routes + plain version).

Replaces ``lstm_unet_tpu/ops/pallas/convlstm_cell.py::fused_convlstm_level``.
From ``gx [B,H,W,4F]`` (x-conv + bias, computed outside), ``h, c [B,H,W,F]``
and ``wh [K,K,F,4F]``: the KxK SAME recurrent conv of ``h`` (rounded to wh's
dtype) with f32 accumulation, plus ``gx``, then the K1 gate math. Only
``h'`` and ``c'`` are written; the 4F gates never reach device memory.
Returns ``(h', c')`` — the reverse of K1's ``(c', h')`` — in h's and c's
dtypes.

The TPU kernel's limits (B = 1, F and W multiples of 128, H of 4, 5x5 only,
its VMEM budget) were the TPU's. On the card :func:`route` picks one of two
kernels by dtype and shape, each with its own launch count:

- ``"wgmma"`` (``csrc/convlstm_wgmma.cu``, :data:`WGMMA_COUNT`): bf16 compute
  (state bf16 or f32), ``F % 64 == 0``, K in {1, 3, 5}, any B, H, W. An
  implicit GEMM on the tensor cores with the gate math as its epilogue; Wh
  goes in packed (:func:`pack_wh`). It takes every ConvLSTM level of the
  flagship model.
- ``"simt"`` (``csrc/convlstm_cell.cu``, :data:`COUNT`): everything else that
  fits one block's shared memory — the halo'd h tile for all F channels plus
  one Wh chunk within the 227 KB a Hopper block can use
  (:func:`smem_bytes`). It serves f32 compute (tensor cores have no true f32
  mode, and TF32 would break the 2e-5 tolerance: flagship level 0 only, F >=
  256 at 5x5 does not fit) and the tiny model's narrow levels.

A level neither route takes raises; the cell checks :func:`supported` first.

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

COUNT = _build.LaunchCount()        # the SIMT route
WGMMA_COUNT = _build.LaunchCount()  # the bf16 tensor-core route

# block geometry of csrc/convlstm_cell.cu (SIMT route)
TILE_H, TILE_W, FEAT_SLICE, CHUNK = 8, 16, 32, 4
KERNEL_SIZES = (1, 3, 5, 7)
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

# block geometry of csrc/convlstm_wgmma.cu (tensor-core route): tiles of 2
# rows x 64 pixels x 64 features (256 gate columns), 64-channel chunks, a
# 3-stage Wh ring
TC_ROWS, TC_COLS, TC_FEAT, TC_CHUNK, TC_STAGES = 2, 64, 64, 64, 3
TC_KERNEL_SIZES = (1, 3, 5)
GRID_LIMIT = 65535  # gridDim.z of the SIMT kernel


def smem_bytes(k: int, feat: int) -> int:
    """Shared memory one SIMT block needs: the f32 halo'd h tile for all
    ``feat`` channels plus one f32 Wh chunk (all taps, 4 gates, one slice)."""
    return 4 * (feat * (TILE_H + k - 1) * (TILE_W + k - 1)
                + k * k * CHUNK * 4 * FEAT_SLICE)


def wgmma_smem_bytes(k: int) -> int:
    """Shared memory one tensor-core block needs: the Wh ring, two bf16 h
    tiles of one chunk (each channel group padded to an odd number of 16-byte
    units) and 12 mbarriers."""
    plane = (((TC_ROWS + k - 1) * (TC_COLS + k - 1)) | 1) * 16
    return (TC_STAGES * TC_CHUNK * 4 * TC_FEAT * 2 + 2 * (TC_CHUNK // 8) * plane
            + (2 * TC_STAGES + 4) * 8)


def route(h: int, w: int, feat: int, k: int, batch: int,
          dtype: torch.dtype = torch.float32) -> Optional[str]:
    """The K4 kernel that takes a level of a square ``k`` x ``k`` kernel in
    compute ``dtype``: ``"wgmma"``, ``"simt"``, or None (neither)."""
    if min(h, w, feat, batch) <= 0:
        return None
    if dtype == torch.bfloat16 and k in TC_KERNEL_SIZES and feat % TC_CHUNK == 0:
        return "wgmma"
    if (k in KERNEL_SIZES and batch * -(-feat // FEAT_SLICE) <= GRID_LIMIT
            and smem_bytes(k, feat) <= SMEM_LIMIT):
        return "simt"
    return None


def supported(h: int, w: int, feat: int, kh: int, kw: int, batch: int,
              dtype: torch.dtype = torch.float32) -> bool:
    """Whether a fused kernel takes this level in compute ``dtype`` (else the
    cell runs the plain conv + K1)."""
    return kh == kw and route(h, w, feat, kh, batch, dtype) is not None


def _count(gx: torch.Tensor, h: torch.Tensor, wh: torch.Tensor) -> _build.LaunchCount:
    b, hh, ww, feat = h.shape
    r = route(hh, ww, feat, wh.shape[0], b, gx.dtype)
    return WGMMA_COUNT if r == "wgmma" else COUNT


# ---------------------------------------------------------------- Wh pack
#
# The tensor-core kernel reads Wh as [F/64 column tiles][F/64 chunks][K*K taps]
# tiles of [8 channel groups][256 columns][8 channels], each 32 KB and in the
# no-swizzle K-major layout wgmma reads from shared memory. Column n of a tile
# (n16 = n // 16, r = n % 16) holds gate 2 * (r // 8) + r % 2 of feature
# 64 * tile + 16 * ((r % 8) // 2) + n16: per 16 columns [i f i f i f i f | g o g
# o g o g o], so one thread's accumulator fragment holds i, f, g and o of the
# same 16 features. _pack_dims splits wh [K*K, F, 4F] into (tap, chunk, group,
# channel, gate // 2, gate % 2, tile, feature // 16 % 4, feature % 16).
_PACK_PERM = (6, 1, 0, 2, 8, 4, 7, 5, 3)
_UNPACK_PERM = tuple(sorted(range(9), key=_PACK_PERM.__getitem__))


def _pack_dims(k: int, feat: int):
    return (k * k, feat // TC_CHUNK, TC_CHUNK // 8, 8, 2, 2, feat // TC_FEAT, 4, TC_FEAT // 4)


def pack_wh(wh: torch.Tensor) -> torch.Tensor:
    """``wh [K,K,F,4F]`` (any strides) -> the tensor-core kernel's packed
    ``[F/64, F/64, K*K, 8, 256, 8]``, in one copy."""
    k, _, feat, _ = wh.shape
    if feat % TC_CHUNK:
        raise ValueError(f"the packed Wh needs F % {TC_CHUNK} == 0, got F={feat}")
    t = wh.reshape(_pack_dims(k, feat)).permute(_PACK_PERM)
    return t.reshape(feat // TC_FEAT, feat // TC_CHUNK, k * k, TC_CHUNK // 8,
                     4 * TC_FEAT, 8).contiguous()


def unpack_wh(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_wh`: ``[K,K,F,4F]``."""
    kk, feat = packed.shape[2], packed.shape[0] * TC_FEAT
    k = round(kk ** 0.5)
    dims = [_pack_dims(k, feat)[p] for p in _PACK_PERM]
    t = packed.reshape(dims).permute(_UNPACK_PERM)
    return t.reshape(k, k, feat, 4 * feat).contiguous()


# ---------------------------------------------------------------- versions


def fused_convlstm_level_plain(gx: torch.Tensor, h: torch.Tensor,
                               c: torch.Tensor, wh: torch.Tensor,
                               recurrent_activation: str = "sigmoid"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both routes: the recurrent conv in f32 on the
    h rounded to wh's dtype (exact products, f32 sums, as the kernels), then
    the gate math. Counted on the route the wrapper would take."""
    _count(gx, h, wh).plain += 1
    k = wh.shape[0]
    feat = c.shape[-1]
    hx = h.to(wh.dtype).float().permute(0, 3, 1, 2)
    acc = F.conv2d(hx, wh.float().permute(3, 2, 0, 1), padding=k // 2)
    z = acc.permute(0, 2, 3, 1) + gx.float()
    c_new, h_new = gate_math(z[..., :feat], z[..., feat:2 * feat],
                             z[..., 2 * feat:3 * feat], z[..., 3 * feat:],
                             c.float(), recurrent_activation)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def fused_convlstm_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                         wh: torch.Tensor, recurrent_activation: str = "sigmoid"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', c')`` of one ConvLSTM level, layouts as in the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel that
    :func:`route` names (any other device raises). ``gx`` and ``wh`` share
    the compute dtype, ``h`` and ``c`` the state dtype, each float32 or
    bfloat16. ``gx``, ``h`` and ``c`` are contiguous; ``wh`` may be a view
    (it is packed or made contiguous here).
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
    if h.device.type == "cpu":
        return fused_convlstm_level_plain(gx, h, c, wh, recurrent_activation)
    if h.device.type != "cuda":
        raise ValueError(f"no fused ConvLSTM kernel for device {h.device}")
    if (gx.dtype != wh.dtype or h.dtype != c.dtype
            or gx.dtype not in _build.DTYPES or h.dtype not in _build.DTYPES):
        raise TypeError(f"fused ConvLSTM kernel takes float32/bfloat16 with "
                        f"gx/wh and h/c dtypes equal, got gx {gx.dtype}, wh "
                        f"{wh.dtype}, h {h.dtype}, c {c.dtype}")
    if not all(t.is_contiguous() for t in (gx, h, c)):
        raise ValueError("fused ConvLSTM kernel needs contiguous gx, h and c")
    which = route(hh, ww, feat, k, b, gx.dtype)
    if which is None:
        raise ValueError(f"fused ConvLSTM kernel does not take {k}x{k}, F={feat}, "
                         f"B={b}, {gx.dtype}; check supported() first")
    if recurrent_activation not in _build.ACTIVATIONS:
        raise ValueError(f"unknown recurrent activation {recurrent_activation!r}")
    if which == "wgmma":
        return wgmma_level(gx, h, c, pack_wh(wh), k, recurrent_activation)
    act = _build.ACTIVATIONS[recurrent_activation]
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    wh = wh.contiguous()
    with torch.cuda.device(h.device):
        err = _build.library().lut_convlstm_level(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), wh.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k, act,
            _build.DTYPES[gx.dtype], _build.DTYPES[h.dtype], _build.stream_handle(h))
    _build.check(err, "lut_convlstm_level")
    COUNT.kernel += 1
    return h_out, c_out


def wgmma_level(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                packed: torch.Tensor, k: int, recurrent_activation: str = "sigmoid"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core launch on Wh already packed by :func:`pack_wh`, for
    CUDA tensors that :func:`fused_convlstm_level` has checked (it packs per
    call; this entry lets a caller time the kernel without the pack)."""
    b, hh, ww, feat = h.shape
    if packed.shape != (feat // TC_FEAT, feat // TC_CHUNK, k * k, TC_CHUNK // 8,
                        4 * TC_FEAT, 8) or packed.dtype != torch.bfloat16:
        raise ValueError(f"packed Wh {tuple(packed.shape)} {packed.dtype} is not "
                         f"pack_wh's for {k}x{k}, F={feat}")
    if any(t.data_ptr() % 16 for t in (gx, h, c)):
        raise ValueError("the tensor-core K4 needs 16-byte aligned gx, h and c")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    with torch.cuda.device(h.device):
        err = _build.library().lut_convlstm_level_wgmma(
            gx.data_ptr(), h.data_ptr(), c.data_ptr(), packed.data_ptr(),
            h_out.data_ptr(), c_out.data_ptr(), b, hh, ww, feat, k,
            _build.ACTIVATIONS[recurrent_activation], _build.DTYPES[h.dtype],
            _build.stream_handle(h))
    _build.check(err, "lut_convlstm_level_wgmma")
    WGMMA_COUNT.kernel += 1
    return h_out, c_out

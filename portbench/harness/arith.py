"""The benchmark's arithmetic: model flops, peaks, kernel bounds, kernel kinds.

Frozen copies, so that the yardstick does not move with the program:

- :func:`conv_sites`, :func:`conv_flops` and :func:`train_flops` are
  ``lstm_unet_tpu_torch/bench.py``'s model-flop count (2·H·W·K²·cin·cout over
  every conv, from the widths alone, whichever kernel computes it; a
  training step counts the forward, every weight grad and the input grads
  autograd needs, no remat recompute);
- :data:`PEAK_FLOPS` its dense H100 SXM peaks, :data:`HBM_BPS` the data
  sheet's HBM3 rate;
- :func:`kind` is ``scripts/profile_torch_stream.py``'s classification of
  a device kernel by its name;
- the bounds are those of the port's kernel table (``PERF.md`` section 6,
  ``chip_smoke.py::conv_bound`` and its K1, K2 and K4 byte and operation
  counts): the least time the card could take, the larger of the
  operations over their peak and the bytes, each read once and written
  once, over the HBM rate.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 495e12}
HBM_BPS = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}

Site = Tuple[str, int, int, int, int, int]  # (site, H, W, K, cin, cout)


def conv_sites(widths: Dict, height: int, width: int) -> List[Site]:
    """Every conv of one forward frame of one lane, in the order the model
    runs them; a ConvLSTM layer is two sites, ``.../x`` and ``.../h``."""
    sites = []
    cin, skips = 1, []
    depth = len(widths["down_conv_kernels"])
    for lvl in range(depth):
        h, w = height >> lvl, width >> lvl
        for j, (k, f) in enumerate(widths["lstm_kernels"][lvl]):
            sites.append((f"encoder/{lvl}/lstm/{j}/x", h, w, k, cin, 4 * f))
            sites.append((f"encoder/{lvl}/lstm/{j}/h", h, w, k, f, 4 * f))
            cin = f
        for j, (k, f) in enumerate(widths["down_conv_kernels"][lvl]):
            sites.append((f"encoder/{lvl}/convs/{j}", h, w, k, cin, f))
            cin = f
        skips.append(cin)
    for lvl in reversed(range(depth)):
        h, w = height >> lvl, width >> lvl
        c = cin + skips[lvl]
        for j, (k, f) in enumerate(widths["up_conv_kernels"][lvl]):
            sites.append((f"decoder/{lvl}/convs/{j}", h, w, k, c, f))
            c = f
        cin = c
    sites.append(("head", height, width, 1, cin, 3))
    return sites


def site_flops(site: Site) -> int:
    _, h, w, k, cin, cout = site
    return 2 * h * w * k * k * cin * cout


def conv_flops(widths: Dict, height: int, width: int) -> int:
    """Model flops of one forward frame of one lane."""
    return sum(site_flops(s) for s in conv_sites(widths, height, width))


def train_flops(widths: Dict, height: int, width: int, batch: int, unroll: int) -> int:
    """Model flops of one truncated-BPTT step of ``batch`` lanes of ``unroll``
    frames: forward, every weight grad, the input grads autograd needs (not
    the frame-reading conv's, nor the first frame's h-convs')."""
    sites = conv_sites(widths, height, width)
    fwd = sum(site_flops(s) for s in sites)
    first_h = sum(site_flops(s) for s in sites if s[0].endswith("/h"))
    return batch * (unroll * (3 * fwd - site_flops(sites[0])) - first_h)


def kind(name: str) -> str:
    """A device kernel's kind, by its name."""
    if "conv_int8_wgmma" in name:
        return "int8 conv wgmma"
    if "conv_int8_smallk" in name:
        return "int8 conv small-K"
    if "conv_int8" in name:
        return "int8 conv"
    if "convlstm_narrow" in name:
        return "K4 narrow"
    if "Tf32x3" in name:
        return "K4 tf32x3"
    if "convlstm_wgmma" in name:
        return "K4 wgmma"
    if "convlstm_level" in name:
        return "K4 SIMT"
    if "gate_update_bwd" in name:
        return "K2"
    if "gate_update" in name:
        return "K1"
    if "ccl_" in name:
        return "K3"
    if "grow_into_band" in name or "erosion_distance" in name:
        return "postprocess loops"
    if any(t in name for t in ("dgrad", "wgrad")):
        return "conv backward"
    if any(t in name for t in ("fprop", "xmma", "cutlass", "convolve", "implicit_gemm",
                               "winograd", "fft")):
        return "conv"
    if "Nhwc" in name or "Nchw" in name:
        return "layout"
    return "elementwise/other"


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least seconds: operations over ``peak`` against bytes over HBM."""
    return max(ops / peak, nbytes / HBM_BPS)


def int8_conv_bound_s(widths: Dict, height: int, width: int, lanes: int,
                      fused_cell: bool) -> float:
    """Summed bound of one step's int8 convs: per site ``2·M·N·K`` at the
    int8 peak against bf16 x read once, the int8 weights, the bf16 output
    and the f32 scale and bias; fused, the h-convs run in K4 instead."""
    total = 0.0
    for site, h, w, k, cin, cout in conv_sites(widths, height, width):
        if fused_cell and site.endswith("/h"):
            continue
        m = lanes * h * w
        ops = 2.0 * m * cout * k * k * cin
        nbytes = m * cin * 2 + cout * k * k * cin + 2 * m * cout + 8 * cout
        total += bound_s(ops, nbytes, PEAK_FLOPS["int8"])
    return total


def convlstm_bound_s(widths: Dict, height: int, width: int, lanes: int,
                     dtype: str) -> float:
    """Summed bound of one step's K4 launches (one a ConvLSTM layer): the
    h-conv's operations at the dtype's peak against gx, h, c read and h',
    c' written (8F a pixel) and Wh read once."""
    el = BYTES[dtype]
    total = 0.0
    for site, h, w, k, cin, cout in conv_sites(widths, height, width):
        if not site.endswith("/h"):
            continue
        f = cin
        ops = 2.0 * lanes * h * w * k * k * f * 4 * f
        nbytes = el * (lanes * h * w * 8 * f + k * k * f * 4 * f)
        total += bound_s(ops, nbytes, PEAK_FLOPS[dtype])
    return total


def lstm_gates_bound_s(widths: Dict, height: int, width: int, batch: int, unroll: int,
                       dtype: str, forward_passes: int) -> float:
    """Summed bound of one training step's K1 and K2 launches, bytes only:
    K1 reads the gates (4F) and c (F) and writes c' and h' (2F); K2 reads
    the gates, c, dc' and dh' and writes dgates and dc (12F in all). K1 runs
    once a layer a frame in each of ``forward_passes`` (2 under full remat:
    the forward and its recompute), K2 once."""
    el = BYTES[dtype]
    total = 0.0
    for site, h, w, _, cin, _ in conv_sites(widths, height, width):
        if not site.endswith("/h"):
            continue
        rows = batch * unroll * h * w
        total += forward_passes * rows * 7 * cin * el / HBM_BPS
        total += rows * 12 * cin * el / HBM_BPS
    return total


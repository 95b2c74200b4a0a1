"""lstm_unet_tpu_torch — the PyTorch / CUDA port of ``lstm_unet_tpu``.

Streaming ConvLSTM U-Net inference for cell segmentation on an NVIDIA
Hopper GPU. The JAX package ``lstm_unet_tpu`` beside it is the reference
this package is tested against; this package imports neither JAX nor it.
Each module sits at the same path and name as its JAX counterpart:

- ``config``     — architecture and inference knobs
- ``io``         — TIFF codec, preprocessing, sequence reader, synthetic data
- ``ops``        — convs, ConvLSTM cell, CCL, postprocess
- ``ops.kernels``— the hand-written CUDA kernels (sources in ``csrc/``) and
                   their plain PyTorch versions
- ``models``     — ``ULSTMnet2D``
- ``checkpoint`` — the JAX param tree <-> ``state_dict`` bridge
- ``engine``     — the streaming inference driver
- ``cli``        — ``python -m lstm_unet_tpu_torch.cli.inference2d``
"""

__version__ = "0.1.0"

"""lstm_unet_tpu_torch — the PyTorch / CUDA port of ``lstm_unet_tpu``.

Streaming ConvLSTM U-Net inference and truncated-BPTT training for cell
segmentation on an NVIDIA Hopper GPU. The JAX package ``lstm_unet_tpu``
beside it is the reference this package is tested against; this package
imports neither JAX nor it. Each module sits at the same path and name as
its JAX counterpart:

- ``config``     — architecture, inference and training knobs
- ``io``         — TIFF codec, preprocessing, sequence readers, synthetic data
- ``ops``        — convs, ConvLSTM cell, CCL, postprocess
- ``ops.kernels``— the hand-written CUDA kernels (sources in ``csrc/``) and
                   their plain PyTorch versions
- ``models``     — ``ULSTMnet2D``
- ``metrics``    — SEG and DET scores (numpy)
- ``checkpoint`` — the JAX param tree <-> ``state_dict`` bridge, checkpoints
- ``engine``     — streaming inference, the train step and the trainer
- ``parallel``   — process groups, the 'data' / 'spatial' mesh, halo exchange
- ``cli``        — ``python -m lstm_unet_tpu_torch.cli.{inference2d,train2d,
                   ctc_sweep,ctc_score,ckpt_avg,import_tf}``
- ``scripts``    — the workflow scripts (``select_best``, ``calibrate_recipe``,
                   ``postprocess_sweep``, ``carry_drift``, ...), the
                   counterparts of the reference's ``scripts/*.py``
"""

__version__ = "0.1.0"

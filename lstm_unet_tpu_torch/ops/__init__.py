"""Convs, the ConvLSTM cell, CCL and the postprocess (counterpart of
``lstm_unet_tpu/ops``); the hand-written kernels live in ``ops.kernels``."""

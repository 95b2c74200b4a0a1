"""TIFF codec, preprocessing, sequence reader and synthetic data
(counterpart of ``lstm_unet_tpu/io``)."""

"""CTC SEG and DET measures (counterpart of ``lstm_unet_tpu/metrics``)."""

from .det import det_counts, det_measure_sequence, det_score  # noqa: F401
from .seg import seg_measure, seg_measure_sequence  # noqa: F401

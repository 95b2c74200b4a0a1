from .ulstm_unet import (  # noqa: F401
    ModelConfig,
    ULSTMnet2D,
    cast_params_for_inference,
)

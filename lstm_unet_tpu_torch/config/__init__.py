from .params import (  # noqa: F401
    InferenceParams,
    NetKernelParams,
    default_net_kernel_params,
    load_recipe,
    tiny_net_kernel_params,
)

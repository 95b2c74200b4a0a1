from .params import (  # noqa: F401
    CTCParams,
    InferenceParams,
    NetKernelParams,
    ParamsBase,
    default_net_kernel_params,
    load_recipe,
    tiny_net_kernel_params,
)

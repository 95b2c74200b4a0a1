from .ckpt import CheckpointManager, resolve_model_dir, save_model_params  # noqa: F401
from .convert import (  # noqa: F401
    flatten_tree,
    load_model,
    opt_state_from_jax,
    opt_state_from_npz,
    opt_state_to_npz,
    params_from_jax,
    params_to_jax,
)

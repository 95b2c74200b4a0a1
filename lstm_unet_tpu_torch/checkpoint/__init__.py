from .ckpt import (CheckpointManager, average_checkpoints, resolve_model_dir,  # noqa: F401
                   save_model_params)
from .convert import (  # noqa: F401
    flatten_tree,
    load_model,
    opt_state_from_jax,
    opt_state_from_npz,
    opt_state_to_npz,
    params_from_jax,
    params_to_jax,
)

from .convert import (  # noqa: F401
    flatten_tree,
    load_model,
    params_from_jax,
    params_to_jax,
)

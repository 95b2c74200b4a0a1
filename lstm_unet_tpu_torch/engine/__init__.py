from .infer import (  # noqa: F401
    StreamingInferenceEngine,
    resolve_device,
    run_inference,
)

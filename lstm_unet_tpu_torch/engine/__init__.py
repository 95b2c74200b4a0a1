from .infer import (  # noqa: F401
    StreamingInferenceEngine,
    resolve_device,
    run_inference,
    run_inference_batched,
)

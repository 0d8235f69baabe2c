from repro_torch.optim.adamw import (  # noqa: F401
    OptimConfig, adamw_init, adamw_update, warmup_cosine,
)

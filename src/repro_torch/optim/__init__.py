from repro_torch.optim.adamw import (  # noqa: F401
    AdamState,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    init_state,
)

from repro_torch.models.model_zoo import build_model  # noqa: F401

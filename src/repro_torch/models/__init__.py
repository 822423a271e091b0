from repro_torch.models.registry import LMModel, get_model  # noqa: F401

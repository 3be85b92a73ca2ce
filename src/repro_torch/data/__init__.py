from repro_torch.data.pipeline import DataIterator, SyntheticLM  # noqa: F401

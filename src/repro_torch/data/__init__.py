from repro_torch.data.pipeline import SyntheticTokens, DataCursor  # noqa: F401

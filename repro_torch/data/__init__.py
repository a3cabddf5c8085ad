from .pipeline import DataConfig, text_len, train_batches  # noqa: F401

from repro_torch.data.pipeline import SyntheticTextDataset, ByteTokenizer, make_batches  # noqa: F401

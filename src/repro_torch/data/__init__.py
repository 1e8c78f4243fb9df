from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLMDataset

__all__ = ["DataConfig", "SyntheticLMDataset", "Prefetcher"]

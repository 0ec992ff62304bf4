from .pipeline import DataConfig, Prefetcher, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "make_pipeline"]

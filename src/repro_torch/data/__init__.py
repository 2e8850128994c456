from .pipeline import PipelineConfig, Prefetcher, TokenPipeline

__all__ = ["PipelineConfig", "TokenPipeline", "Prefetcher"]

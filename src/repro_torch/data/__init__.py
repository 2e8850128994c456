from .pipeline import (PipelineConfig, Prefetcher, TokenPipeline,
                       pipeline_for_arch)

__all__ = ["PipelineConfig", "TokenPipeline", "Prefetcher",
           "pipeline_for_arch"]

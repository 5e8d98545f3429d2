from .pipeline import TokenPipeline

__all__ = ["TokenPipeline"]

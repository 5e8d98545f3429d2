from .analysis import Roofline, analyze, model_flops_for

__all__ = ["Roofline", "analyze", "model_flops_for"]

"""Data substrate: synthetic + memmap token pipelines on hetflow host tasks."""
from .pipeline import MemmapSource, Pipeline, PipelineConfig, SyntheticSource

__all__ = ["MemmapSource", "Pipeline", "PipelineConfig", "SyntheticSource"]

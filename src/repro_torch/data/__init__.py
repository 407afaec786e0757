from .pipeline import DataPipeline, make_pipeline
from .sources import MemmapTokenSource, SyntheticLMSource

__all__ = ["DataPipeline", "make_pipeline", "MemmapTokenSource",
           "SyntheticLMSource"]

from .engine import InferenceEngine, Overloaded, Request, RequestHandle

__all__ = ["InferenceEngine", "Overloaded", "Request", "RequestHandle"]

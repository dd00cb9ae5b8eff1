from .engine import ICPEngine, ICPResult

__all__ = ["ICPEngine", "ICPResult"]

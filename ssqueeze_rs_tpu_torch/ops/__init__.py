from .ssq_cwt import ssq_cwt, issq_cwt
from .ssqueeze import ssqueeze

__all__ = ["ssq_cwt", "issq_cwt", "ssqueeze"]

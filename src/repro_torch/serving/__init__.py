from .engine import ServeEngine
from .request_queue import DurableRequestQueue

__all__ = ["DurableRequestQueue", "ServeEngine"]

from .pipeline import DurableShardQueue, TokenSource

__all__ = ["DurableShardQueue", "TokenSource"]

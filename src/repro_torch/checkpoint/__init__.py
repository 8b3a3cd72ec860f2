from .checkpointer import DurableCheckpointer

__all__ = ["DurableCheckpointer"]

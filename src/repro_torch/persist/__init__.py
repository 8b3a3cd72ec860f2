from .cursors import CursorFile
from .wal import WalStats, WriteAheadLog

__all__ = ["CursorFile", "WalStats", "WriteAheadLog"]

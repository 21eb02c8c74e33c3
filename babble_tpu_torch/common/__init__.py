from .errors import StoreError, StoreErrType, is_store_err
from .lru import LRU, Memo
from .rolling_index import RollingIndex

__all__ = ["StoreError", "StoreErrType", "is_store_err", "LRU", "Memo", "RollingIndex"]

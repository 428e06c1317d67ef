from . import store
from .blocking import Blocking, blocks_in_volume
from .store import file_reader

__all__ = ["store", "Blocking", "blocks_in_volume", "file_reader"]

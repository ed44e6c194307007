"""A name -> object registry with a ``register()`` decorator (port of
``sk_gs_tpu/framework/registry.py``), the backbone of the reference's
NETWORKS / DATASETS factories."""
from __future__ import annotations

from typing import Callable, Dict, Generic, Optional, TypeVar

T = TypeVar('T')


class Registry(Dict[str, T], Generic[T]):
    def __init__(self, ignore_case: bool = False):
        super().__init__()
        self.ignore_case = ignore_case

    def _key(self, name: str) -> str:
        return name.lower() if self.ignore_case else name

    def register(self, name: Optional[str] = None) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            key = name or getattr(obj, '__name__', str(obj))
            self[self._key(key)] = obj
            return obj
        return deco

    def __getitem__(self, name: str) -> T:
        key = self._key(name)
        if key not in self:
            raise KeyError(f"'{name}' not registered; have {list(self)}")
        return super().__getitem__(key)


NETWORKS: Registry = Registry()
DATASETS: Registry = Registry()

"""Lazily-constructed per-process shared objects.

SharedVariable/SharedSingleton analogue (io/http/SharedVariable.scala:18-60):
stage closures capture a *recipe*; the value is built once per process on
first use and shared across partition tasks (e.g. one HTTP connection pool,
one placed model). Pickling transports only the recipe. This is the
PyTorch port's copy of ``mmlspark_tpu.io.shared``, unchanged but for the
example.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")

# process-wide cache keyed by singleton id, survives re-pickling
_SINGLETONS: dict[str, Any] = {}
_LOCK = threading.Lock()


class SharedVariable(Generic[T]):
    """Holds fn-constructed value, built lazily once per process."""

    def __init__(self, constructor: Callable[[], T]):
        self._constructor = constructor
        self._value: Any = None
        self._built = False
        self._lock = threading.Lock()

    def get(self) -> T:
        if not self._built:
            with self._lock:
                if not self._built:
                    self._value = self._constructor()
                    self._built = True
        return self._value

    def __getstate__(self) -> dict:
        return {"_constructor": self._constructor}

    def __setstate__(self, state: dict) -> None:
        self._constructor = state["_constructor"]
        self._value, self._built = None, False
        self._lock = threading.Lock()


class SharedSingleton(Generic[T]):
    """Like SharedVariable but deduplicated process-wide by key, so multiple
    deserialized copies of a stage share one instance."""

    def __init__(self, key: str, constructor: Callable[[], T]):
        self.key = key
        self._constructor = constructor

    def get(self) -> T:
        with _LOCK:
            if self.key not in _SINGLETONS:
                _SINGLETONS[self.key] = self._constructor()
            return _SINGLETONS[self.key]

    @staticmethod
    def invalidate(key: str) -> None:
        with _LOCK:
            _SINGLETONS.pop(key, None)

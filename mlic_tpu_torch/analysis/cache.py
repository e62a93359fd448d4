"""Memory and disk memoization (port of ``mlic_tpu/analysis/cache.py``;
reference ``analysis/cache.py:6-56`` ``SimpleCache``): an LRU layer in
memory over a pickle file a result on disk, keyed by the function's name
and arguments."""

from __future__ import annotations

import hashlib
import os
import pickle
from collections import OrderedDict
from functools import wraps
from pathlib import Path


class SimpleCache:
    def __init__(self, cache_dir: str = "simple_cache",
                 memory_cache_size: int = 100):
        self.cache_dir = Path(cache_dir)
        self.memory_cache_size = memory_cache_size
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._memory: OrderedDict[str, object] = OrderedDict()

    def _key(self, name: str, args, kwargs) -> str:
        payload = repr((name, args, tuple(sorted(kwargs.items()))))
        return hashlib.sha1(payload.encode()).hexdigest()[:24]

    def _remember(self, key: str, value):
        self._memory[key] = value
        self._memory.move_to_end(key)
        while len(self._memory) > self.memory_cache_size:
            self._memory.popitem(last=False)

    def cached(self, func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            key = f"{func.__name__}_{self._key(func.__name__, args, kwargs)}"
            if key in self._memory:
                self._memory.move_to_end(key)
                return self._memory[key]
            path = self.cache_dir / f"{key}.pkl"
            if path.exists():
                try:
                    with open(path, "rb") as f:
                        result = pickle.load(f)
                    self._remember(key, result)
                    return result
                except (pickle.PickleError, EOFError, TypeError):
                    pass
            result = func(*args, **kwargs)
            self._remember(key, result)
            with open(path, "wb") as f:
                pickle.dump(result, f)
            return result

        return wrapper

    def clear_cache(self, memory_only: bool = False):
        self._memory.clear()
        if not memory_only:
            for p in self.cache_dir.glob("*.pkl"):
                os.remove(p)

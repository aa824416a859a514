"""Teacher-prediction cache: reuse ensemble predictions on hot windows
(port of ``repro/serve/teacher_cache.py``, on the port's tracer).

Serving a teacher ensemble is the expensive query class — K forward
passes over a public batch. But public-pool windows are *deterministic
in (seed, step)* (`PublicPool.sample`), so the ensemble output for a
(window id, teacher set) pair is a pure value: repeated queries against
a hot window can be answered from cache, byte-identical to recompute
(asserted in tests/test_torch_serve.py).

`TeacherPredictionCache` is an LRU keyed by
``(window_id, tuple(sorted(teacher_set)))`` — teacher-set order never
splits an entry. `CacheLedger` is the `CommMeter`-style book of what
the cache did: hit/miss/eviction counts, the bytes each book moved, and
per-window hit counters (which windows are actually hot), with a
``summary()`` the benchmarks fold into their rows.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Any, Callable, Dict, Tuple

import numpy as np

from repro_torch.obs import tracer as trace

CacheKey = Tuple[int, Tuple[int, ...]]


def _nbytes(value: Dict[str, np.ndarray]) -> int:
    return int(sum(np.asarray(v).nbytes for v in value.values()))


class CacheLedger:
    """Hit/miss/eviction books of the teacher cache (CommMeter idiom:
    plain counters + dict books, ``summary()`` for the metric fold)."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.hit_bytes = 0  # bytes served without recompute
        self.miss_bytes = 0  # bytes computed and inserted
        self.by_window_hits: Dict[int, int] = defaultdict(int)
        self.by_window_misses: Dict[int, int] = defaultdict(int)

    def record_hit(self, window_id: int, nbytes: int) -> None:
        self.hits += 1
        self.hit_bytes += nbytes
        self.by_window_hits[window_id] += 1

    def record_miss(self, window_id: int, nbytes: int) -> None:
        self.misses += 1
        self.miss_bytes += nbytes
        self.by_window_misses[window_id] += 1

    def record_eviction(self, window_id: int) -> None:
        self.evictions += 1

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def summary(self) -> Dict[str, float]:
        return {"hits": float(self.hits),
                "misses": float(self.misses),
                "evictions": float(self.evictions),
                "hit_rate": self.hit_rate(),
                "hit_bytes": float(self.hit_bytes),
                "miss_bytes": float(self.miss_bytes)}

    def format_table(self) -> str:
        lines = ["window     hits   misses"]
        for w in sorted(set(self.by_window_hits)
                        | set(self.by_window_misses)):
            lines.append(f"{w:6d} {self.by_window_hits[w]:8d} "
                         f"{self.by_window_misses[w]:8d}")
        s = self.summary()
        lines.append(f"total: {self.hits} hits / {self.misses} misses "
                     f"({s['hit_rate']:.0%}), {self.evictions} evicted")
        return "\n".join(lines)


class TeacherPredictionCache:
    """LRU of ensemble predictions keyed by (window id, teacher set)."""

    def __init__(self, capacity: int = 8, ledger: CacheLedger = None):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self.ledger = ledger if ledger is not None else CacheLedger()
        self._store: "OrderedDict[CacheKey, Dict[str, np.ndarray]]" = \
            OrderedDict()

    @staticmethod
    def key(window_id: int, teachers) -> CacheKey:
        return (int(window_id), tuple(sorted(int(t) for t in teachers)))

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: CacheKey) -> bool:
        return key in self._store

    def get_or_compute(self, window_id: int, teachers,
                       compute: Callable[[], Dict[str, np.ndarray]]
                       ) -> Tuple[Dict[str, np.ndarray], bool]:
        """The cached value for (window, teacher set), computing and
        inserting on miss. Returns ``(predictions, hit)``; a hit returns
        the stored arrays themselves — byte-identical to what the miss
        computed."""
        key = self.key(window_id, teachers)
        with trace.span("serve/cache", window=key[0],
                        teachers=len(key[1])):
            if key in self._store:
                self._store.move_to_end(key)
                value = self._store[key]
                self.ledger.record_hit(key[0], _nbytes(value))
                return value, True
            value = compute()
            self._store[key] = value
            self.ledger.record_miss(key[0], _nbytes(value))
            while len(self._store) > self.capacity:
                old_key, _ = self._store.popitem(last=False)
                self.ledger.record_eviction(old_key[0])
            return value, False

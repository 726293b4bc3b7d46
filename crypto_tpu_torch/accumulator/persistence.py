"""Accumulator state storage: the port's own copy of
`crypto_tpu/accumulator/persistence.py` (reference
`vb_accumulator/src/persistence.rs:8-107`): `State` /
`InitialElementsStore` traits with in-memory implementations.  Real
deployments back these with a KV store."""

from __future__ import annotations

from typing import Iterable, Protocol


class State(Protocol):
    def add(self, element) -> None: ...
    def remove(self, element) -> None: ...
    def has(self, element) -> bool: ...
    def size(self) -> int: ...


class InMemoryState:
    def __init__(self):
        self.db = set()

    def add(self, element):
        self.db.add(int(element))

    def remove(self, element):
        self.db.discard(int(element))

    def has(self, element) -> bool:
        return int(element) in self.db

    def size(self) -> int:
        return len(self.db)

    def elements(self) -> Iterable[int]:
        return iter(self.db)


class InMemoryInitialElements:
    def __init__(self):
        self.db = set()

    def add(self, element):
        self.db.add(int(element))

    def has(self, element) -> bool:
        return int(element) in self.db

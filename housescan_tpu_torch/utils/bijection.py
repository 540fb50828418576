"""Bijections between key sets and contiguous integer ranges (a copy of
``housescan_tpu/utils/bijection.py``): map an ordered key collection, with
duplicates, to ``0..n-1`` in first-occurrence order, both ways. Turns
room and plane IDs into dense indices for solver matrices."""

from __future__ import annotations

from typing import Callable, Hashable, Iterable, List, Tuple, TypeVar

T = TypeVar("T", bound=Hashable)


def ord_nub(items: Iterable[T]) -> List[T]:
    """Deduplicate, keeping the first occurrence of each item, in order."""
    return list(dict.fromkeys(items))


def biject(items: Iterable[T]) -> Tuple[Callable[[T], int], Callable[[int], T]]:
    """``(index_of, item_of)`` mapping items <-> ``0..n-1`` in
    first-occurrence order. ``index_of`` raises ``KeyError`` for an
    unknown item, ``item_of`` ``IndexError`` out of range."""
    uniq = ord_nub(items)
    index = {item: i for i, item in enumerate(uniq)}

    def index_of(item: T) -> int:
        return index[item]

    def item_of(i: int) -> T:
        return uniq[i]

    return index_of, item_of

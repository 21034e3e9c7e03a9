"""Host-side page allocation for the paged KV serve engine (port of
``repro.serve.paging``, without prefix sharing).

The device never allocates: the :class:`PageAllocator` owns the free list,
per-slot page ownership and a numpy mirror of the device page table. The
scheduler consults it for admission (by FREE PAGES, not free slots), grows
slots on demand before each decode chunk and releases pages at retire.

Invariants:

* page 0 is the reserved SCRATCH page: never allocated, never validly read
  (dead-slot appends land there);
* live slots own disjoint page sets; the mirror row ``table[slot, :n]``
  lists slot ``slot``'s pages in position order, -1 beyond;
* admission reserves each request's WORST-CASE page count
  (max(bucket pages, ceil((prompt + max_new) / ps))), so on-demand growth
  during decode can never fail.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np


class PoolExhausted(RuntimeError):
    """A page pop found the pool dry. Reservation accounting rules this out
    for every admitted request, so it signals a broken invariant."""


class PageAllocator:
    def __init__(self, num_pages: int, capacity: int, max_pages: int,
                 page_size: int, sharing: bool = False):
        if sharing:
            raise NotImplementedError("prefix sharing is not ported yet")
        if num_pages < 2:
            raise ValueError("need at least one non-scratch page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.free: deque = deque(range(1, num_pages))   # page 0 = scratch
        self.owned: Dict[int, List[int]] = {}           # slot -> page ids
        self.reserved: Dict[int, int] = {}              # slot -> worst case
        self.table = np.full((capacity, max_pages), -1, np.int32)
        self.dirty = False                              # mirror vs device
        self.peak_pages = 0                             # high-water mark

    def _pop_free(self) -> int:
        if not self.free:
            raise PoolExhausted("allocator exhausted despite reservation "
                                "accounting")
        return self.free.popleft()

    # -- accounting ----------------------------------------------------------

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def pages_in_use(self) -> int:
        return sum(len(pages) for pages in self.owned.values())

    @property
    def available(self) -> int:
        """Pages free AND not spoken for by an existing reservation."""
        outstanding = sum(self.reserved[s] - len(self.owned[s])
                          for s in self.reserved)
        return len(self.free) - outstanding

    def _reservation(self, bucket_len: int, true_len: int,
                     max_new: int) -> int:
        # bucket pages are allocated up front; decode appends stop at
        # position true_len + max_new - 1 (dead-slot re-appends go to
        # scratch or the slot's own last page, never elsewhere)
        return max(self.pages_for(bucket_len),
                   self.pages_for(true_len + max_new))

    def can_admit(self, bucket_len: int, true_len: int, max_new: int) -> bool:
        return self._reservation(bucket_len, true_len, max_new) \
            <= self.available

    # -- lifecycle -----------------------------------------------------------

    def admit(self, slot: int, bucket_len: int, true_len: int,
              max_new: int) -> np.ndarray:
        """Reserve the worst case, allocate the bucket pages, rewrite the
        mirror row. Returns the page ids for the prefill's page scatter."""
        if slot in self.owned:
            raise ValueError(f"slot {slot} already holds pages")
        need = self._reservation(bucket_len, true_len, max_new)
        if need > self.available:
            raise ValueError("admission must check can_admit first")
        n_bucket = self.pages_for(bucket_len)
        ids = [self._pop_free() for _ in range(n_bucket)]
        self.owned[slot] = ids
        self.reserved[slot] = need
        self.table[slot, :] = -1
        self.table[slot, :n_bucket] = ids
        self.dirty = True
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return np.asarray(ids, np.int32)

    def ensure(self, slot: int, last_pos: int) -> None:
        """Grow ``slot`` so position ``last_pos`` has a page (on-demand
        decode allocation, covered by the admission reservation)."""
        need = last_pos // self.page_size + 1
        if need > self.reserved[slot]:
            raise ValueError(f"slot {slot}: position {last_pos} is past its "
                             f"reservation of {self.reserved[slot]} pages")
        pages = self.owned[slot]
        while len(pages) < need:
            pid = self._pop_free()
            self.table[slot, len(pages)] = pid
            pages.append(pid)
            self.dirty = True
        self.peak_pages = max(self.peak_pages, self.pages_in_use)

    def release(self, slot: int) -> None:
        """Retire ``slot``: its pages go back to the free list unzeroed
        (junk is masked at read time)."""
        self.free.extend(self.owned.pop(slot))
        del self.reserved[slot]
        self.table[slot, :] = -1
        self.dirty = True

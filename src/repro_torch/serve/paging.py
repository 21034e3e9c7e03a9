"""Host-side page allocation for the paged KV serve engine (port of
``repro.serve.paging``, with prefix sharing, the overload subsystem's
optimistic mode, and the snapshot ``clone`` and ``page_alloc`` fault hook
of the restart supervisor).

The device never allocates: the :class:`PageAllocator` owns the free list,
per-slot page ownership and a numpy mirror of the device page table. The
scheduler consults it for admission (by FREE PAGES, not free slots), grows
slots on demand before each decode chunk and releases pages at retire.

Prefix sharing (``sharing=True``) adds a :class:`PrefixIndex` (a radix
tree over resident token-id page chains) and per-page REFERENCE COUNTS:

* a page's refcount is (#slot page-table rows mapping it) + (1 if the
  index registers it); a page returns to the free list only at refcount 0;
* shared pages are READ-ONLY by construction: full pages are immutable
  once written (decode appends only ever touch a slot's own tail page,
  which is never index-registered while the slot lives), and a matched
  partial boundary page is COPIED at admission (copy-on-write) so the
  divergent suffix never writes a page another reader maps;
* the index is a CACHE: pages held only by the index (refcount 1) are
  evicted leaf-first in LRU order when the free list runs dry. A page
  counts as RECLAIMABLE only when its WHOLE subtree is index-only: dedup
  registration can leave a refcount-1 interior node above a slot-mapped
  leaf, which leaf-first eviction never reaches. Shared admission likewise
  excludes the matched pages it is about to pin from the reclaimable
  count: retaining them makes them unevictable, so they must not fund
  their own region.

Invariants:

* page 0 is the reserved SCRATCH page: never allocated, never validly read
  (dead-slot appends land there);
* live slots WRITE disjoint page sets; the mirror row ``table[slot, :n]``
  lists slot ``slot``'s pages in position order, -1 beyond (shared prefix
  pages may appear in several rows: all readers);
* admission reserves each request's WORST-CASE page count
  (max(pages mapped at admission, ceil((prompt + max_new) / ps))), so
  on-demand growth during decode can never fail. With sharing off every
  refcount is exactly 1 and the arithmetic is that of the allocator
  without sharing.

OPTIMISTIC mode (``optimistic=True``, the overload scheduler of
``serve/overload.py``): admission drops the worst-case reservation and
asks only for the pages mapped RIGHT NOW (the prefill bucket, or the COW
+ suffix region); ``reserved`` then tracks the high-water mark of actual
ownership instead of a promise. So ``_pop_free`` can run dry mid-decode:
it raises :class:`PoolExhausted` and the overload scheduler preempts a
victim, frees or host-swaps its pages and retries the growth. Every
successful pop lands in the table row before the next, so a failed
``ensure`` leaves the mirror and ownership consistent and can be retried.
"""
from __future__ import annotations

import copy
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _TrieNode:
    """One FULL page of a resident token chain: ``edge`` is the page's
    ``page_size`` token ids, ``page`` the pool page holding their KV."""
    __slots__ = ("edge", "page", "children", "parent", "stamp")

    def __init__(self, edge: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["_TrieNode"], stamp: int):
        self.edge = edge
        self.page = page
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.stamp = stamp


class PrefixIndex:
    """Radix tree over resident token-id page chains, page-granular edges.

    ``match`` walks full-page edges and then token by token into ONE
    boundary page (the longest common prefix with a child edge): the
    copy-on-write source. ``insert`` registers a chain's full pages;
    existing nodes keep their page (dedup: the first resident copy wins).
    Eviction is leaf-first in LRU ``stamp`` order and only ever frees pages
    no slot maps (refcount 1, index-only); ``evictions`` counts them.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _TrieNode(None, -1, None, 0)
        self._clock = 0
        self.pages: Dict[int, _TrieNode] = {}   # pid -> owning node
        self.evictions = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def __len__(self) -> int:
        return len(self.pages)

    def match(self, tokens: np.ndarray, cap: int
              ) -> Tuple[List[int], Optional[int], int]:
        """Longest indexed prefix of ``tokens[:cap]``.

        Returns ``(full_pages, boundary_page, rem)``: the page chain for
        ``len(full_pages) * ps`` fully matched tokens, plus (optionally) a
        boundary page whose first ``rem`` (< ps) tokens also match (the COW
        source). Touches every matched node's LRU stamp."""
        ps = self.page_size
        toks = [int(x) for x in tokens]
        node, i, pages = self.root, 0, []
        stamp = self._tick()
        while i + ps <= cap:
            child = node.children.get(tuple(toks[i:i + ps]))
            if child is None:
                break
            child.stamp = stamp
            pages.append(child.page)
            node, i = child, i + ps
        # token-granular tail: longest common prefix with ONE child edge
        # (ties go to the lowest page id)
        boundary, rem = None, 0
        limit = min(ps, cap - i)
        if limit > 0:
            tail = toks[i:i + limit]
            for edge, child in node.children.items():
                lcp = 0
                while lcp < limit and edge[lcp] == tail[lcp]:
                    lcp += 1
                if lcp > rem or (lcp == rem and boundary is not None
                                 and child.page < boundary):
                    if lcp > 0:
                        boundary, rem = child.page, lcp
            if boundary is not None:
                self.pages[boundary].stamp = stamp
        return pages, boundary, rem

    def insert(self, tokens: np.ndarray, row_pages: Sequence[int],
               alloc: "PageAllocator") -> int:
        """Register the full pages of ``tokens`` along ``row_pages``
        (position order). New nodes retain their page; nodes already
        present keep the existing resident copy. Returns #new nodes."""
        ps = self.page_size
        toks = [int(x) for x in tokens]
        n_full = min(len(toks) // ps, len(row_pages))
        node, added = self.root, 0
        stamp = self._tick()
        for j in range(n_full):
            edge = tuple(toks[j * ps:(j + 1) * ps])
            child = node.children.get(edge)
            if child is None:
                pid = int(row_pages[j])
                child = _TrieNode(edge, pid, node, stamp)
                node.children[edge] = child
                self.pages[pid] = child
                alloc._retain(pid)
                added += 1
            else:
                child.stamp = stamp
            node = child
        return added

    def reclaimable(self, refcnt: Dict[int, int]) -> int:
        """Pages leaf-first eviction can actually reach: a node's page
        counts only if it AND its whole subtree are index-only (refcount
        1)."""
        def walk(node):
            count, subtree_ok = 0, True
            for child in node.children.values():
                c, ok = walk(child)
                count += c
                subtree_ok = subtree_ok and ok
            ok = subtree_ok and refcnt.get(node.page, 0) == 1
            return count + (1 if ok else 0), ok
        return sum(walk(child)[0] for child in self.root.children.values())

    def evict_one(self, alloc: "PageAllocator") -> Optional[int]:
        """Drop the LRU reclaimable LEAF (refcount 1: held only by the
        index) and release its page. Returns the page id freed, or None if
        nothing is reclaimable."""
        victim = None
        for pid, node in self.pages.items():
            if node.children or alloc.refcnt.get(pid, 0) != 1:
                continue
            if victim is None or node.stamp < victim.stamp or (
                    node.stamp == victim.stamp and pid < victim.page):
                victim = node
        if victim is None:
            return None
        del victim.parent.children[victim.edge]
        del self.pages[victim.page]
        alloc._release_page(victim.page)
        self.evictions += 1
        return victim.page


class PoolExhausted(RuntimeError):
    """A page pop found the pool dry with nothing reclaimable. Under
    optimistic admission this is the overload scheduler's cue to preempt
    a victim and retry; otherwise reservation accounting rules it out for
    every admitted request, so it signals a broken invariant."""


class PageAllocator:
    def __init__(self, num_pages: int, capacity: int, max_pages: int,
                 page_size: int, sharing: bool = False,
                 optimistic: bool = False):
        if num_pages < 2:
            raise ValueError("need at least one non-scratch page")
        self.optimistic = optimistic
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.free: deque = deque(range(1, num_pages))   # page 0 = scratch
        self.owned: Dict[int, List[int]] = {}           # slot -> page ids
        self.reserved: Dict[int, int] = {}              # slot -> worst case
        self.refcnt: Dict[int, int] = {}                # pid -> holders
        self.table = np.full((capacity, max_pages), -1, np.int32)
        self.dirty = False                              # mirror vs device
        self.peak_pages = 0                             # high-water mark
        self.index = PrefixIndex(page_size) if sharing else None
        # chaos hook (serve/faults.py): fires the "page_alloc" site inside
        # _pop_free, possibly mid-admission with the allocator half
        # mutated: the state a snapshot restore must be able to discard
        self.injector = None

    def clone(self) -> "PageAllocator":
        """Deep copy of every allocation structure (free list, ownership,
        reservations, refcounts, the mirror table, the prefix index with
        its LRU stamps) for snapshot / restore. The injector is SHARED,
        not copied: its per-site counters must keep advancing across
        restores, so that a consumed fault never fires again in replay."""
        inj, self.injector = self.injector, None
        try:
            dup = copy.deepcopy(self)
        finally:
            self.injector = inj
        dup.injector = inj
        return dup

    # -- refcounts -----------------------------------------------------------

    def _retain(self, pid: int) -> None:
        self.refcnt[pid] = self.refcnt.get(pid, 0) + 1

    def _release_page(self, pid: int) -> None:
        rc = self.refcnt[pid] - 1
        if rc == 0:
            del self.refcnt[pid]
            self.free.append(pid)
        else:
            self.refcnt[pid] = rc

    def _pop_free(self) -> int:
        """Pop a free page, evicting LRU index-only pages if the free list
        ran dry (covered by ``available``'s reclaimable term, so a pop
        guarded by ``can_admit`` / the reservation never fails, unless
        admission is optimistic)."""
        if self.injector is not None:
            self.injector.check("page_alloc")
        while not self.free:
            freed = (self.index.evict_one(self)
                     if self.index is not None else None)
            if freed is None:
                if self.optimistic:
                    raise PoolExhausted("page pool dry under optimistic "
                                        "admission")
                raise PoolExhausted("allocator exhausted despite reservation "
                                    "accounting")
        pid = self.free.popleft()
        self._retain(pid)
        return pid

    # -- accounting ----------------------------------------------------------

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def pages_in_use(self) -> int:
        """DISTINCT pages mapped by live slots (shared pages count once)."""
        return len({p for pages in self.owned.values() for p in pages})

    @property
    def reclaimable(self) -> int:
        """Index-held pages eviction can free on demand (whole subtree
        index-only: ``PrefixIndex.reclaimable``)."""
        if self.index is None:
            return 0
        return self.index.reclaimable(self.refcnt)

    @property
    def available(self) -> int:
        """Pages free (or reclaimable from the index) AND not spoken for by
        an existing reservation."""
        outstanding = sum(self.reserved[s] - len(self.owned[s])
                          for s in self.reserved)
        return len(self.free) + self.reclaimable - outstanding

    def _reservation(self, bucket_len: int, true_len: int,
                     max_new: int) -> int:
        # bucket pages are allocated up front; decode appends stop at
        # position true_len + max_new - 1 (dead-slot re-appends go to
        # scratch or the slot's own last page, never elsewhere). Optimistic
        # admission asks for the bucket alone: growth is backed by
        # preemption, not a promise
        if self.optimistic:
            return self.pages_for(bucket_len)
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
        decode allocation, covered by the admission reservation; under
        optimistic admission the reservation follows the growth and a dry
        pool raises :class:`PoolExhausted`)."""
        need = last_pos // self.page_size + 1
        if self.optimistic:
            self.reserved[slot] = max(self.reserved[slot], need)
        elif need > self.reserved[slot]:
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
        """Retire ``slot``: drop one reference per owned page; pages reach
        the free list (unzeroed: junk is masked at read time) only at
        refcount 0, so index-registered or still-shared pages survive."""
        for pid in self.owned.pop(slot):
            self._release_page(pid)
        del self.reserved[slot]
        self.table[slot, :] = -1
        self.dirty = True

    # -- prefix sharing ------------------------------------------------------

    def _index(self) -> PrefixIndex:
        if self.index is None:
            raise ValueError("prefix sharing is off: PageAllocator("
                             "sharing=True) keeps the index")
        return self.index

    def match(self, prompt: np.ndarray
              ) -> Tuple[List[int], Optional[int], int]:
        """Longest indexed prefix of ``prompt``, capped at len - 1 so the
        unshared suffix always holds >= 1 token (prefill must produce the
        first-token logits)."""
        return self._index().match(prompt, cap=len(prompt) - 1)

    def _pinned(self, prefix_pages: Sequence[int],
                boundary: Optional[int]) -> int:
        """Matched pages now counted reclaimable (refcount 1, index-only)
        that shared admission will retain: pinning makes them unevictable,
        so availability checks must not spend them on the region they
        themselves enable."""
        pids = {int(p) for p in prefix_pages}
        if boundary is not None:
            pids.add(int(boundary))
        return sum(1 for pid in pids if self.refcnt.get(pid, 0) == 1)

    def can_admit_shared(self, prefix_pages: Sequence[int],
                         boundary: Optional[int], rem: int,
                         suffix_bucket: int, true_len: int,
                         max_new: int) -> bool:
        """Admission check for a request sharing the matched
        ``prefix_pages`` (plus COW source ``boundary``): only the COW /
        suffix region and future growth come from the pool, and the matched
        pages leave the reclaimable count the moment admission retains
        them."""
        n_region = self.pages_for(rem + suffix_bucket)
        if self.optimistic:
            need = n_region
        else:
            need = max(n_region,
                       self.pages_for(true_len + max_new) - len(prefix_pages))
        return need <= self.available - self._pinned(prefix_pages, boundary)

    def admit_shared(self, slot: int, prefix_pages: Sequence[int],
                     boundary: Optional[int], rem: int,
                     suffix_bucket: int, true_len: int, max_new: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Admit at the fork point: map the matched ``prefix_pages`` into
        the slot's row (retained FIRST, so eviction during the region pops
        can never free them) and allocate the COW / suffix region behind
        them. The ``boundary`` COW source is pinned across the pops too:
        the caller copies it into region page 0 right after (when
        ``rem > 0``), and eviction must not recycle it first. Returns
        (prefix ids, region ids)."""
        self._index()
        if slot in self.owned:
            raise ValueError(f"slot {slot} already holds pages")
        if not self.can_admit_shared(prefix_pages, boundary, rem,
                                     suffix_bucket, true_len, max_new):
            raise ValueError("admission must check can_admit_shared first")
        for pid in prefix_pages:
            self._retain(pid)
        if boundary is not None:
            self._retain(boundary)
        n_region = self.pages_for(rem + suffix_bucket)
        region = [self._pop_free() for _ in range(n_region)]
        if boundary is not None:
            self._release_page(boundary)    # pops done: the COW copy is
                                            # the caller's next operation
        ids = [int(p) for p in prefix_pages] + region
        self.owned[slot] = ids
        self.reserved[slot] = (len(ids) if self.optimistic else
                               max(len(ids),
                                   self.pages_for(true_len + max_new)))
        self.table[slot, :] = -1
        self.table[slot, :len(ids)] = ids
        self.dirty = True
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return (np.asarray(prefix_pages, np.int32),
                np.asarray(region, np.int32))

    def register(self, chain: np.ndarray, slot: int) -> int:
        """Index every FULL page of ``chain`` (token ids whose KV is
        resident in ``slot``'s pages): at admission (the prompt) and at
        retire (prompt + generated tokens whose KV was written). Returns
        #pages newly indexed."""
        return self._index().insert(chain, self.owned[slot], self)

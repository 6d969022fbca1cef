"""Host-side page allocator and radix prefix cache for the paged KV
layout (``repro_torch.models.cache.init_paged_cache``).

Copy of ``repro.genserve.pagepool``.

Two small pure-Python structures drive admission:

``PagePool``
    A free-list allocator over the device page pool with per-page
    refcounts.  Slots and the radix tree both hold references; a page
    returns to the free list when its count reaches zero.  Nothing here
    touches device memory — the pool only decides *which* page ids the
    engine's block tables may use.

``RadixCache``
    A page-granular prefix tree over prompt token ids (SGLang-style,
    coarsened to page boundaries so a tree edge is exactly one page's
    worth of tokens).  ``match`` returns the longest cached prefix as
    (a) whole pages the new slot can map copy-free (refcount++ — true
    sharing) and (b) at most one *partially* matching page, which the
    engine copies on write: a fresh page is allocated, the cached page's
    contents are copied device-side (``cache.copy_pages``) and only the
    copy is mapped, so the divergent suffix never corrupts the cached
    original.  ``insert`` registers a landed prompt's complete pages for
    future admissions; leaves are evicted in LRU order when the free
    list runs dry.

The decoder consumes these during admission (match → start the prefill
cursor after the shared prefix), at landing (insert) and at retirement
(decref the slot's pages).  See ``repro_torch.genserve.decoder``.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import metrics as obs_metrics


class PagePool:
    """Free-list page allocator with refcounts.

    Page ids are ``0 .. n_pages-1``; ``n_pages`` itself is the sentinel
    value block tables use for unmapped entries (device gathers fill
    zeros / scatters drop for it, so the host never allocates it).
    """

    def __init__(self, n_pages: int, page_size: int):
        assert n_pages > 0 and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self.refcount = [0] * n_pages
        # LIFO free list: recently freed pages are reused first, which
        # keeps the working set of pool pages compact
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def sentinel(self) -> int:
        return self.n_pages

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages (refcount 1 each); None if exhausted."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self.refcount[p] == 0
            self.refcount[p] = 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self.refcount[p] > 0, f"incref on free page {p}"
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the ids that hit zero
        (now back on the free list)."""
        freed = []
        for p in pages:
            assert self.refcount[p] > 0, f"decref on free page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def check(self) -> None:
        """Invariant: every page is either free (refcount 0, on the
        free list exactly once) or live (refcount > 0, not on it)."""
        seen = set(self._free)
        assert len(seen) == len(self._free), "duplicate free-list entry"
        for p, rc in enumerate(self.refcount):
            assert rc >= 0
            assert (rc == 0) == (p in seen), (
                f"page {p}: refcount {rc} vs free-list {p in seen}")

    # -- observability ---------------------------------------------------
    def utilization(self) -> float:
        """Fraction of pool pages currently referenced (live)."""
        live = sum(1 for rc in self.refcount if rc > 0)
        return live / self.n_pages

    def stats(self) -> Dict[str, float]:
        """Invariant-checked pool summary for metrics snapshots."""
        self.check()
        return {"n_pages": self.n_pages, "free": len(self._free),
                "live": self.n_pages - len(self._free),
                "utilization": self.utilization(),
                "max_refcount": max(self.refcount, default=0)}

    def leak_check(self, expected_refs: Optional[Dict[int, int]] = None
                   ) -> List[int]:
        """Shutdown leak assertion: with ``expected_refs`` (page ->
        refcount the caller can account for — at decoder teardown, the
        radix tree's node references), any page holding references
        beyond them is a leak.  Leaks are counted into the
        ``pagepool.leaked_pages`` metric and warned; under
        ``REPRO_OBS_STRICT=1`` they raise instead.  Also verifies the
        free-list invariant (``check``).  Returns the leaked page ids."""
        self.check()
        expected = expected_refs or {}
        leaked = [p for p, rc in enumerate(self.refcount)
                  if rc > expected.get(p, 0)]
        if leaked:
            obs_metrics.counter("pagepool.leaked_pages").inc(len(leaked))
            msg = (f"page pool leak: {len(leaked)} page(s) hold "
                   f"unaccounted references at teardown "
                   f"(ids {leaked[:8]}{'...' if len(leaked) > 8 else ''})")
            if os.environ.get("REPRO_OBS_STRICT") == "1":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return leaked


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_use")

    def __init__(self, key: Tuple[int, ...], page: int, parent):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_use = 0


class RadixCache:
    """Page-granular prefix tree over prompt token ids.

    Every edge below the root is labelled with exactly ``page_size``
    token ids and owns one reference on the page holding their KV.
    Prompts that share a prefix share a path; ``match`` walks it.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node((), -1, None)
        self._clock = 0
        self.n_nodes = 0

    # -- lookup ----------------------------------------------------------

    def match(self, tokens: Sequence[int], max_len: int,
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached prefix of ``tokens`` capped at ``max_len``.

        Returns ``(full_pages, partial)``: ``full_pages`` are pool page
        ids whose whole page_size-token span matches (sharable in place
        after an incref); ``partial`` is ``(page, n_tokens)`` for at
        most one further page matching only its first ``n_tokens``
        (copy-on-write material), or None.  The cap exists so a fully
        cached prompt still runs a landing chunk: the caller passes
        ``len(prompt) - 1`` and always prefills at least one token."""
        ps = self.page_size
        self._clock += 1
        node = self.root
        full: List[int] = []
        depth = 0
        while (depth + 1) * ps <= max_len:
            key = tuple(tokens[depth * ps:(depth + 1) * ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._clock
            full.append(child.page)
            node = child
            depth += 1
        # one partially matching page: the child sharing the longest
        # proper token prefix with what remains under the cap
        partial = None
        rest = list(tokens[depth * ps:max_len])
        if rest:
            best = 0
            for key, child in node.children.items():
                n = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    n += 1
                if n > best:
                    best, partial = n, (child.page, n)
                    child.last_use = self._clock
        return full, partial

    # -- insertion -------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Register a landed prompt's complete pages: page j covers
        tokens ``[j*ps, (j+1)*ps)``.  Only whole pages enter the tree
        (the trailing partial page is private to its slot).  Existing
        nodes are kept (first inserter wins); each newly created node
        increfs its page.  Returns the number of nodes created."""
        ps = self.page_size
        self._clock += 1
        node = self.root
        created = 0
        for j, page in enumerate(pages):
            key = tuple(tokens[j * ps:(j + 1) * ps])
            if len(key) < ps:
                break
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, node)
                node.children[key] = child
                self.pool.incref([page])
                self.n_nodes += 1
                created += 1
            child.last_use = self._clock
            node = child
        return created

    # -- eviction --------------------------------------------------------

    def evict(self, need: int) -> int:
        """Drop LRU leaves until ``need`` pages have actually been freed
        (refcount reached zero) or no leaf remains.  Leaves whose page
        is still mapped by a live slot are dropped from the tree too —
        they stop matching immediately and the page frees at slot
        retirement.  Returns the number of pages freed now."""
        freed = 0
        while freed < need:
            leaf = self._lru_leaf()
            if leaf is None:
                break
            del leaf.parent.children[leaf.key]
            self.n_nodes -= 1
            freed += len(self.pool.decref([leaf.page]))
        return freed

    def _lru_leaf(self) -> Optional[_Node]:
        best = None
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                if best is None or n.last_use < best.last_use:
                    best = n
            stack.extend(n.children.values())
        return best

    # -- observability ---------------------------------------------------
    def page_refs(self) -> Dict[int, int]:
        """page id -> number of references the tree holds on it (each
        node owns exactly one).  At decoder teardown these are the only
        references that should remain — ``PagePool.leak_check`` takes
        this as its expected-refs baseline."""
        refs: Dict[int, int] = {}
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            refs[n.page] = refs.get(n.page, 0) + 1
            stack.extend(n.children.values())
        return refs

"""Prefix index (a copy of ``neuronx_distributed_tpu/kvcache/prefix.py``;
evictions count into ``kvcache/evictions_total`` when a registry is given,
and into the plain ``evictions`` attribute always): a token-hash trie
mapping prompt prefixes to shared page chains (RadixAttention, Zheng et al. 2024, on the static-shape page pool).

A serving fleet's prompts repeat — system prompts, few-shot preambles,
multi-turn histories.  The prefix index deduplicates their KV at PAGE
granularity: each trie node is one page worth of tokens (the *page key*,
:func:`page_keys`) and owns the physical page holding that page's K/V.  Two
prompts whose padded rows agree on a page-aligned prefix share the physical
pages of that prefix (refcounted in the :class:`~.allocator.BlockAllocator`),
and an exact full-prompt hit additionally carries the prefill's last-position
logits as the terminal payload, so a repeated prompt skips prefill compute
entirely.

Why keys are built from the PADDED row: the engine left-pads prompts to the
compiled context width, and a token's KV depends on its position *within the
padded row* (RoPE phases come from the validity prefix).  Padding slots are
encoded as :data:`PAD`, so two rows share a page key only when both the
tokens and the padding layout match — which is exactly the condition under
which the cached KV page is bit-identical to what prefill would recompute.
Pages that are ALL padding carry no information (their keys are all
:data:`PAD`, their content is masked out of every attention) and map to the
allocator's NULL page — cacheable structure, zero pages spent.

Chains are immutable once written: prompts occupy page-aligned context
region ``[0, C)`` and decode writes start at ``C``, so a shared prompt page
is never mutated and sharing needs no copy-on-write on this path (the
allocator still provides ``cow`` for callers that share mid-page state).

Eviction is LRU over refcount-0 chains: a leaf whose page only the index
still references (allocator refcount 1) is reclaimable; evicting leaves
bottom-up keeps every active request's chain intact (a pinned descendant
implies pinned ancestors — requests reference whole prefixes).

Pure host-side (no jax) — the trie, refcount and LRU properties are tested
without compiling anything.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Iterator, List, Optional, Sequence, Set, Tuple

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE, BlockAllocator

# page-key code for a left-padding slot (never a valid token id)
PAD = -1

# leading marker of a salted (per-adapter) page key — distinct from PAD and
# from any valid token id, so a salted key can never collide with a plain one
SALT_MARK = -2

EVICTIONS_TOTAL = "kvcache/evictions_total"

PageKey = Tuple[int, ...]


def page_keys(ids_row: Sequence[int], valid_row: Sequence[int],
              page_size: int, salt: int = 0) -> List[PageKey]:
    """Page keys for one padded prompt row: per page, the tuple of token ids
    with padding slots replaced by :data:`PAD`.  ``ids_row`` / ``valid_row``
    are the row's ``[C]`` padded ids and 0/1 validity; ``C`` must divide by
    ``page_size``.

    ``salt`` namespaces the keys (the tenancy subsystem salts with the
    request's LoRA ``adapter_id``): a cached KV page's content depends on
    the adapter that prefilled it (the v projection carries the adapter
    delta), so two requests may share a prefix page only when their tokens,
    padding layout AND adapter all agree.  Non-padding keys grow a leading
    ``(SALT_MARK, salt)`` pair; all-padding pages stay the plain all-PAD
    key — their content is masked out of every attention, so the NULL page
    backs them for free regardless of adapter.  ``salt == 0`` (the
    no-adapter default) keeps the historical key format bit-for-bit, so
    existing tries and fleet fingerprints are unchanged."""
    n = len(ids_row)
    if n % page_size != 0:
        raise ValueError(
            f"row length {n} is not a multiple of page_size {page_size}")
    keys = []
    for p in range(n // page_size):
        lo = p * page_size
        key = tuple(
            int(ids_row[lo + i]) if valid_row[lo + i] else PAD
            for i in range(page_size))
        if salt and not is_padding_key(key):
            key = (SALT_MARK, int(salt)) + key
        keys.append(key)
    return keys


def is_padding_key(key: PageKey) -> bool:
    """True when the page holds no real token (all left-padding) — such
    pages map to the NULL page and cost nothing."""
    return all(t == PAD for t in key)


# -- chain fingerprints (fleet router shadow index) --------------------------
#
# A fleet router steering by prefix affinity needs to know which replica's
# PrefixIndex likely holds a prompt's leading page chain WITHOUT holding the
# chain itself (the router is a front door over N replicas, possibly across
# process boundaries).  A *chain fingerprint* is a stable 64-bit rolling hash
# of a page-key chain: fp_0 = ROOT_FINGERPRINT, fp_n = H(fp_{n-1}, key_n).
# blake2b (not Python ``hash``) so fingerprints agree across processes and
# across runs — the contract between a live index's
# :meth:`PrefixIndex.chain_fingerprints` export and the router-side shadow.

ROOT_FINGERPRINT = 0


def chain_fingerprint(parent_fp: int, key: PageKey) -> int:
    """Extend a chain fingerprint by one page key (rolling, order-sensitive:
    the fingerprint of a chain depends on every key before it)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent_fp).to_bytes(8, "little"))
    h.update(struct.pack(f"<{len(key)}q", *key))
    return int.from_bytes(h.digest(), "little")


def prefix_fingerprints(keys: Sequence[PageKey]) -> List[int]:
    """Fingerprint of every leading chain of ``keys``: element ``i`` is the
    fingerprint of ``keys[:i+1]``.  The router hashes a prompt's page keys
    once and matches depths against a replica shadow set."""
    fps: List[int] = []
    fp = ROOT_FINGERPRINT
    for key in keys:
        fp = chain_fingerprint(fp, key)
        fps.append(fp)
    return fps


class _Node:
    __slots__ = ("key", "page", "children", "parent", "payload", "last_used")

    def __init__(self, key: Optional[PageKey], page: int, parent):
        self.key = key
        self.page = page
        self.children: dict = {}
        self.parent = parent
        self.payload: Any = None
        self.last_used = 0


class PrefixIndex:
    """Page-granular prompt-prefix trie over a :class:`BlockAllocator`.

    - :meth:`lookup` walks the longest matching chain, hands the caller one
      *reference* per matched non-NULL page (release with
      ``allocator.free``), and returns the terminal payload on an exact
      full match;
    - :meth:`insert` registers a freshly prefilled chain (the index takes
      its own reference per new page) with an optional terminal payload
      (the prefill's last-position logits);
    - :meth:`evict` reclaims LRU refcount-0 chains leaf-first until enough
      pages are free.
    """

    def __init__(self, allocator: BlockAllocator, registry: Any = None):
        self.alloc = allocator
        self.evictions = 0
        self.registry = registry
        if registry is not None:
            registry.counter(EVICTIONS_TOTAL)
        self._root = _Node(None, NULL_PAGE, None)
        self._clock = 0
        self._nodes = 0
        # evictable_pages() memo, keyed by (allocator, trie) mutation
        # versions — the per-engine-step gauge export and per-submit gate
        # must not pay an O(trie) walk on steps that mutated nothing
        self._version = 0
        self._evictable_memo = (-1, -1, 0)

    def __len__(self) -> int:
        return self._nodes

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # -- queries -----------------------------------------------------------

    def lookup(self, keys: Sequence[PageKey]) -> Tuple[List[int], Any]:
        """Longest-prefix match.  Returns ``(pages, payload)``: ``pages`` is
        the matched chain's physical page ids (NULL for padding pages); the
        caller now HOLDS one allocator reference on each non-NULL page and
        must ``free`` them when done.  ``payload`` is the terminal payload
        when the match covers *every* key (exact full-prompt hit), else
        None."""
        node = self._root
        pages: List[int] = []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            self.alloc.retain(child.page)
            pages.append(child.page)
            node = child
        payload = node.payload if len(pages) == len(keys) else None
        return pages, payload

    def peek(self, keys: Sequence[PageKey]) -> Tuple[List[int], Any]:
        """:meth:`lookup` without side effects: the longest matching chain's
        pages and (on an exact full match) its terminal payload, taking NO
        allocator references and leaving LRU clocks untouched.  For
        presence probes — the fleet-transfer import path peeks before
        deciding how much of a chain it still needs to move."""
        node = self._root
        pages: List[int] = []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            pages.append(child.page)
            node = child
        payload = node.payload if len(pages) == len(keys) else None
        return pages, payload

    def find_fingerprint(self, fp: int):
        """Resolve a chain fingerprint back to the chain it names: the
        ``(keys, pages, payload)`` of the root-to-node chain whose rolling
        fingerprint equals ``fp``, or None when the index holds no such
        chain.  The export side of the fleet-global prefix directory —
        a directory hit carries only the 64-bit fingerprint, and the
        holding replica reconstructs the chain to serialize from it.  No
        references are taken (pair with :func:`~.transfer.export_chain`,
        which reads under the index's own reference)."""
        stack = [(self._root, ROOT_FINGERPRINT, [], [])]
        while stack:
            node, nfp, keys, pages = stack.pop()
            for child in node.children.values():
                cfp = chain_fingerprint(nfp, child.key)
                ckeys = keys + [child.key]
                cpages = pages + [child.page]
                if cfp == fp:
                    return list(ckeys), list(cpages), child.payload
                stack.append((child, cfp, ckeys, cpages))
        return None

    def insert(self, keys: Sequence[PageKey], pages: Sequence[int],
               payload: Any = None) -> None:
        """Register a chain (one page id per key; NULL for padding pages).
        New nodes take one index-owned reference on their page; existing
        nodes must already hold the SAME page (two chains with equal keys
        hold equal content — a mismatch is an engine bug).  ``payload``
        (when given) is stored on the terminal node."""
        if len(keys) != len(pages):
            raise ValueError(f"{len(keys)} keys vs {len(pages)} pages")
        node = self._root
        for key, page in zip(keys, pages):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(page), node)
                node.children[key] = child
                self.alloc.retain(child.page)  # the index's own reference
                self._nodes += 1
            elif child.page != page:
                raise AssertionError(
                    f"prefix chain divergence: key {key!r} cached as page "
                    f"{child.page}, inserted as {page}")
            self._touch(child)
            node = child
        self._version += 1
        if payload is not None and node is not self._root:
            node.payload = payload

    def chain_fingerprints(self) -> Set[int]:
        """Fingerprint of every chain the index currently caches (one per
        node — each node terminates the chain of keys from the root down to
        it).  The truth a fleet router's per-replica shadow approximates;
        :meth:`~..serving.fleet.FleetRouter` resyncs from it after a replica
        restart so the shadow never credits an index that no longer holds
        the pages."""
        out: Set[int] = set()
        stack = [(self._root, ROOT_FINGERPRINT)]
        while stack:
            node, fp = stack.pop()
            for child in node.children.values():
                cfp = chain_fingerprint(fp, child.key)
                out.add(cfp)
                stack.append((child, cfp))
        return out

    def flush(self) -> int:
        """Drop EVERY cached chain at once — the index's reference on each
        non-NULL page is released (pages active slots or resume pins still
        hold stay allocated under THEIR references; index-only pages return
        to the free list).  Returns the number of nodes dropped.

        The live-weight swap path: cached KV (and terminal prefill logits)
        were computed under the outgoing params, so serving them to a
        post-swap admission would leak old-version output past the version
        boundary.  A flush is cheaper than being wrong — the cache re-warms
        under the new weights."""
        dropped = self._nodes
        for node in self._iter():
            self.alloc.free(node.page)  # no-op on NULL structure pages
        self._root = _Node(None, NULL_PAGE, None)
        self._nodes = 0
        self._version += 1
        return dropped

    # -- eviction ----------------------------------------------------------

    def _iter(self) -> Iterator[_Node]:
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _evictable(self, node: _Node) -> bool:
        # leaf whose page nobody but the index references (NULL pages are
        # structure-only; dropping them frees nothing but may expose an
        # evictable parent)
        if node.children:
            return False
        return node.page == NULL_PAGE or self.alloc.refcount(node.page) == 1

    def evictable_pages(self) -> int:
        """Pages reclaimable by leaf-first eviction right now: a page counts
        only when it is index-only (refcount 1) AND its entire subtree is
        too — a pinned descendant shields every ancestor, since eviction
        removes leaves first.  (Engine chains pin whole prefixes, making
        the two conditions coincide; the count stays honest for any
        caller.)  Memoized on the allocator/trie mutation versions, so the
        steady decode path (no refcount changes) pays O(1), not O(trie)."""
        key = (self.alloc.version, self._version)
        if self._evictable_memo[:2] == key:
            return self._evictable_memo[2]
        total = 0

        def walk(node: _Node) -> bool:
            """True iff ``node``'s whole subtree (itself included) can go."""
            nonlocal total
            sub_ok = True
            for child in node.children.values():
                if not walk(child):
                    sub_ok = False
            if node.page != NULL_PAGE and self.alloc.refcount(node.page) != 1:
                return False
            if sub_ok and node.page != NULL_PAGE:
                total += 1
            return sub_ok

        for child in self._root.children.values():
            walk(child)
        self._evictable_memo = (*key, total)
        return total

    def evict(self, need_pages: int) -> int:
        """Evict least-recently-used unpinned leaves until ``need_pages``
        pages were freed (or nothing evictable remains).  Returns the pages
        actually freed."""
        freed = 0
        while freed < need_pages:
            leaf = min(
                (n for n in self._iter() if self._evictable(n)),
                key=lambda n: n.last_used, default=None)
            if leaf is None:
                break
            del leaf.parent.children[leaf.key]
            self._nodes -= 1
            self._version += 1
            if leaf.page != NULL_PAGE:
                self.alloc.free(leaf.page)
                freed += 1
                self.evictions += 1
                if self.registry is not None:
                    self.registry.counter(EVICTIONS_TOTAL).inc()
        return freed

    # -- invariants --------------------------------------------------------

    def assert_invariants(self) -> None:
        """Every cached non-NULL page is allocated with refcount >= 1 and
        owned by exactly one node; parent links are consistent."""
        seen: set = set()
        count = 0
        for node in self._iter():
            count += 1
            assert node.parent.children.get(node.key) is node, (
                "trie parent/child link broken")
            if node.page != NULL_PAGE:
                assert node.page not in seen, (
                    f"page {node.page} owned by two trie nodes")
                seen.add(node.page)
                assert self.alloc.refcount(node.page) >= 1, (
                    f"cached page {node.page} is not allocated")
        assert count == self._nodes, (
            f"node count drifted: walked {count}, tracked {self._nodes}")

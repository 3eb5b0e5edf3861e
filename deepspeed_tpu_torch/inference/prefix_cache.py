"""Host-side prefix-cache index: a block-granular radix trie over prompt
token prefixes, mapping to slots of a device-side KV prefix pool (a copy of
``deepspeed_tpu/inference/prefix_cache.py``, which imports no jax).

RadixAttention-style prompt reuse (SGLang, Zheng et al. 2023) split the way
everything in this codebase is split — a *host* data structure making all
the policy decisions (longest-match lookup, insertion policy, ref-counted
LRU eviction) and a *device* pool the ServingEngine drives with exactly two
programs (``prefix_fetch`` / ``prefix_store``, inference/serving.py).
This module is pure python, so the policy layer is unit
testable without a device and reusable by any engine that owns a pool.

Layout contract with the serving engine:

  * prefixes are keyed at ``block``-token granularity: an entry at trie
    depth d covers prompt positions ``[0, d * block)``. Block granularity
    bounds both the trie branching work (one dict hop per block, not per
    token) and the number of distinct entry lengths.
  * each entry owns one pool slot — an independent ``[L, Pmax, H, Dh]`` KV
    window (entries never share device state, so evicting a short prefix
    can never corrupt a longer one that extends it).
  * ``refs`` counts in-flight requests admitted through the entry; the LRU
    evictor only considers ``refs == 0`` entries, so an in-use prefix is
    never evicted even under a full pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PrefixEntry:
    """One cached prefix: ``length`` prompt tokens resident in ``pool_slot``.
    ``path`` is the trie block-key chain from the root — the entry's tokens,
    kept so eviction and trie compaction can locate/rebuild its node without
    a tree search."""

    length: int
    pool_slot: int
    path: tuple = ()
    hits: int = 0
    refs: int = 0
    last_used: int = 0


@dataclass
class _Node:
    """Trie node at depth d (= d*block prefix tokens). ``count`` tracks how
    many admitted prompts traversed this node — the min_hits insertion
    policy's popularity signal."""

    children: dict = field(default_factory=dict)
    count: int = 0
    entry: Optional[PrefixEntry] = None


@dataclass
class InsertResult:
    entry: Optional[PrefixEntry]  # the entry to store into (None = nothing to do)
    created: bool = False  # True: caller must run the prefix_store program
    evicted: Optional[PrefixEntry] = None  # LRU victim freed for this insert
    skipped: str = ""  # non-empty: why no entry was created


class PrefixIndex:
    """Trie + pool-slot allocator. The ServingEngine calls:

    ``lookup(tokens, max_len)``   on admission — longest cached prefix
    ``acquire``/``release``       around each request's lifetime (refcount)
    ``insert(tokens, max_len)``   once the prompt's KV sits in the slot
                                  cache — decides whether/where to cache it
    """

    def __init__(self, n_slots: int, block: int = 16,
                 insert_policy: str = "always", min_hits: int = 2):
        if n_slots < 1:
            raise ValueError(f"prefix pool needs >= 1 slot, got {n_slots}")
        if block < 1:
            raise ValueError(f"prefix block must be >= 1, got {block}")
        if insert_policy not in ("always", "min_hits"):
            raise ValueError(
                f"insert_policy must be always|min_hits, got {insert_policy!r}")
        if min_hits < 1:
            raise ValueError(f"min_hits must be >= 1, got {min_hits}")
        self.n_slots = int(n_slots)
        self.block = int(block)
        self.insert_policy = insert_policy
        self.min_hits = int(min_hits)
        self._root = _Node()
        self._free = list(range(self.n_slots))[::-1]  # pop() yields slot 0 first
        self._entries: list[PrefixEntry] = []
        self._clock = 0  # LRU timestamps: monotonic op counter, not wall time
        self._n_nodes = 0  # live trie nodes (root excluded); compaction trigger
        self.compactions = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.inserts = 0
        self.evictions = 0
        self.insert_skips = 0

    # -- helpers --------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens, max_len: int):
        """Block-key sequence for ``tokens[:max_len]`` rounded DOWN to a
        whole number of blocks."""
        n = min(len(tokens), max_len) // self.block
        return [tuple(int(t) for t in tokens[i * self.block:(i + 1) * self.block])
                for i in range(n)]

    # -- lookup ---------------------------------------------------------

    def lookup(self, tokens, max_len: int) -> Optional[PrefixEntry]:
        """Longest cached prefix of ``tokens`` with length <= max_len, or
        None. Bumps hit/miss stats and the winner's LRU stamp; the caller
        must ``acquire()`` the entry for the request's lifetime."""
        node = self._root
        best = None
        for key in self._blocks(tokens, max_len):
            node = node.children.get(key)
            if node is None:
                break
            if node.entry is not None:
                best = node.entry
        if best is None:
            self.misses += 1
            return None
        self.hits += 1
        best.hits += 1
        best.last_used = self._tick()
        self.tokens_reused += best.length
        return best

    def peek(self, tokens, max_len: int) -> int:
        """Length of the longest cached prefix of ``tokens`` (<= max_len)
        with NO side effects — no hit/miss counters, no LRU bump, no entry
        handed out. The Router's prefix-affinity dispatch polls every
        replica's index per submit; a stats-bumping probe would corrupt
        hit-rate telemetry and LRU order on the replicas that lose the
        dispatch. 0 = no cached prefix."""
        node = self._root
        best = 0
        for key in self._blocks(tokens, max_len):
            node = node.children.get(key)
            if node is None:
                break
            if node.entry is not None:
                best = node.entry.length
        return best

    def acquire(self, entry: PrefixEntry) -> None:
        entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        entry.refs -= 1
        if entry.refs < 0:
            raise RuntimeError("prefix entry released more times than acquired")

    # -- insert / evict -------------------------------------------------

    def _alloc_slot(self) -> tuple[Optional[int], Optional[PrefixEntry]]:
        """A free pool slot, evicting the LRU refs==0 entry if needed.
        (None, None) = pool full of in-use entries; skip the insert."""
        if self._free:
            return self._free.pop(), None
        victims = [e for e in self._entries if e.refs == 0]
        if not victims:
            return None, None
        victim = min(victims, key=lambda e: e.last_used)
        self._drop(victim)
        self.evictions += 1
        return self._free.pop(), victim

    def _drop(self, entry: PrefixEntry) -> None:
        node = self._walk(entry.path)
        if node is not None and node.entry is entry:
            node.entry = None
        self._entries.remove(entry)
        self._free.append(entry.pool_slot)

    def _walk(self, path) -> Optional[_Node]:
        node = self._root
        for key in path:
            node = node.children.get(key)
            if node is None:
                return None
        return node

    def _maybe_compact(self) -> None:
        """Bound host memory: every admitted prompt grows the trie by up to
        max_len/block nodes (that's how min_hits learns popularity), but
        one-off prompts' paths would otherwise accumulate forever. When the
        node count far exceeds what the RESIDENT entries need, rebuild the
        trie from their paths — node counts reset to ``min_hits`` (each
        surviving prefix already proved popular enough to be cached), cold
        paths vanish."""
        needed = sum(len(e.path) for e in self._entries)
        if self._n_nodes <= max(1024, 8 * needed):
            return
        self._root = _Node()
        self._n_nodes = 0
        for entry in self._entries:
            node = self._root
            for key in entry.path:
                nxt = node.children.get(key)
                if nxt is None:
                    nxt = node.children[key] = _Node()
                    self._n_nodes += 1
                nxt.count = max(nxt.count, self.min_hits)
                node = nxt
            node.entry = entry
        self.compactions += 1

    def insert(self, tokens, max_len: int) -> InsertResult:
        """Record ``tokens[:max_len]``'s traversal and (policy permitting)
        cache its longest block-aligned prefix. ``max_len`` caps the cached
        length — the caller passes min(prompt_len - 1, pool window): at
        least one suffix token must remain to prefill (the first sampled
        token needs the last prompt position's logits), and an entry longer
        than the pool window could not be stored."""
        keys = self._blocks(tokens, max_len)
        if not keys:
            return InsertResult(None, skipped="prefix shorter than one block")
        # checked BEFORE the walk so even a stream of never-cached unique
        # prompts (min_hits policy) stays bounded; the walk below adds at
        # most len(keys) nodes past the cap
        self._maybe_compact()
        node = self._root
        path = []
        for key in keys:
            nxt = node.children.get(key)
            if nxt is None:
                nxt = node.children[key] = _Node()
                self._n_nodes += 1
            nxt.count += 1
            path.append(nxt)
            node = nxt
        if self.insert_policy == "min_hits":
            # deepest node along this prompt's path that enough prompts have
            # shared — one-off tails never consume a pool slot
            depth = max((i + 1 for i, n in enumerate(path)
                         if n.count >= self.min_hits), default=0)
            if depth == 0:
                self.insert_skips += 1
                return InsertResult(
                    None, skipped=f"no prefix with >= {self.min_hits} traversals")
            target = path[depth - 1]
        else:
            depth = len(path)
            target = path[-1]
        if target.entry is not None:
            return InsertResult(target.entry, skipped="already cached")
        slot, evicted = self._alloc_slot()
        if slot is None:
            self.insert_skips += 1
            return InsertResult(None, evicted=None,
                                skipped="pool full of in-use prefixes")
        entry = PrefixEntry(length=depth * self.block, pool_slot=slot,
                            path=tuple(keys[:depth]), last_used=self._tick())
        target.entry = entry
        self._entries.append(entry)
        self.inserts += 1
        return InsertResult(entry, created=True, evicted=evicted)

    # -- reporting ------------------------------------------------------

    @property
    def used_slots(self) -> int:
        return len(self._entries)

    def entries(self) -> list[PrefixEntry]:
        return list(self._entries)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "n_slots": self.n_slots,
            "used_slots": self.used_slots,
            "block": self.block,
            "insert_policy": self.insert_policy,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "tokens_reused": self.tokens_reused,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "insert_skips": self.insert_skips,
            "trie_nodes": self._n_nodes,
            "compactions": self.compactions,
            "entries": [
                {"length": e.length, "pool_slot": e.pool_slot, "hits": e.hits,
                 "refs": e.refs, "last_used": e.last_used}
                for e in sorted(self._entries, key=lambda e: -e.hits)
            ],
        }

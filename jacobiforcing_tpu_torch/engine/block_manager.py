"""Host-side paged-KV page allocator with hash-based prefix caching.

Copy of `jacobiforcing_tpu/engine/block_manager.py` (the Python allocator; the
native C++ one waits for a later slice).  Re-design of the reference
BlockManager (inference_engine/engine/block_manager.py:23-565).
What carries over:
  * free-list + refcount pages;
  * prefix caching via a CHAINED hash over full pages of token ids
    (compute_hash, block_manager.py:67-91): h_i = H(h_{i-1} || tokens_i);
    allocation walks the prompt's full pages and reuses matching cached pages
    (allocate, block_manager.py:135-168);
  * deallocated pages keep their hash and sit on an LRU free list so a later
    identical prompt can revive them.

What does NOT carry over — all of the reference's Jacobi special cases
(temporary draft blocks :278-389, trim_seq_tail :391, trim_kv_only :472,
trim_kv_only_fast :534, _allocate_block_no_clear :114): the device loop
writes draft KV into the sequence's own margin pages and validity is a length
counter, so the host only sizes capacity (`ensure_capacity`).

The cached-prefix length is capped at prompt_len - 1 so (a) the last prompt
token is always re-forwarded to produce first-token logits, and (b) every
position the device loop ever writes (>= cached_len) lives in pages private to
the sequence — shared pages are never written.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

from jacobiforcing_tpu_torch.engine.sequence import Sequence


def _chain_hash(prev: Optional[bytes], tokens: List[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    if prev is not None:
        h.update(prev)
    h.update(b"|".join(str(t).encode() for t in tokens))
    return h.digest()


class Page:
    __slots__ = ("page_id", "ref_count", "hash", "token_ids")

    def __init__(self, page_id: int):
        self.page_id = page_id
        self.ref_count = 0
        self.hash: Optional[bytes] = None
        self.token_ids: Optional[tuple] = None

    def reset(self):
        self.hash = None
        self.token_ids = None


class BlockManager:
    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.pages: List[Page] = [Page(i) for i in range(num_pages)]
        # LRU free list: page_id -> None (OrderedDict preserves order)
        self.free: "OrderedDict[int, None]" = OrderedDict((i, None) for i in range(num_pages))
        self.hash_to_page: Dict[bytes, int] = {}
        self.prefix_cache_hits = 0
        self.prefix_cache_queries = 0

    # ------------------------------------------------------------------
    @property
    def num_free_pages(self) -> int:
        return len(self.free)

    def _take_page(self, page_id: Optional[int] = None) -> Page:
        if page_id is None:
            page_id, _ = self.free.popitem(last=False)  # oldest-freed first
        else:
            del self.free[page_id]
        page = self.pages[page_id]
        if page.hash is not None and self.hash_to_page.get(page.hash) == page_id:
            # page is being repurposed: drop its cache entry
            del self.hash_to_page[page.hash]
        page.reset()
        page.ref_count = 1
        return page

    def _release_page(self, page_id: int) -> None:
        page = self.pages[page_id]
        page.ref_count -= 1
        assert page.ref_count >= 0
        if page.ref_count == 0:
            self.free[page_id] = None  # keeps hash: revivable prefix cache

    # ------------------------------------------------------------------
    def can_allocate(self, seq: Sequence, margin_tokens: int = 0) -> bool:
        need = (len(seq) + margin_tokens + self.page_size - 1) // self.page_size
        return need <= self.num_free_pages  # conservative: ignores cache hits

    def allocate_prompt(self, seq: Sequence, margin_tokens: int = 0) -> int:
        """Allocate pages for the prompt (+ jacobi margin); returns cached_len.

        cached_len counts leading tokens whose KV is already in reused cached
        pages (multiple of page_size, capped at prompt_len - 1).
        """
        assert not seq.block_table
        P = self.page_size
        prompt = seq.token_ids
        n_pages = (len(prompt) + margin_tokens + P - 1) // P
        cached_len = 0
        prev_hash: Optional[bytes] = None
        chain_alive = True
        for i in range(n_pages):
            toks = prompt[i * P : (i + 1) * P]
            full = len(toks) == P
            h = _chain_hash(prev_hash, toks) if (full and chain_alive) else None
            hit: Optional[Page] = None
            if h is not None:
                self.prefix_cache_queries += 1
                cand_id = self.hash_to_page.get(h)
                # Only a contiguous-from-0 hit extends cached_len; cap the
                # cached prefix at prompt_len - 1 (see module docstring).
                if (
                    cand_id is not None
                    and cached_len == i * P
                    and (i + 1) * P <= len(prompt) - 1
                    and self.pages[cand_id].token_ids == tuple(toks)
                ):
                    hit = self.pages[cand_id]
            if hit is not None:
                if hit.ref_count == 0:
                    del self.free[hit.page_id]  # revive from LRU free list
                hit.ref_count += 1
                cached_len += P
                self.prefix_cache_hits += 1
                page = hit
            else:
                page = self._take_page()
                if h is not None:
                    page.hash = h
                    page.token_ids = tuple(toks)
                    self.hash_to_page[h] = page.page_id
            if not full:
                chain_alive = False
            prev_hash = h
            seq.block_table.append(page.page_id)
        seq.num_cached_tokens = cached_len
        return cached_len

    def ensure_capacity(self, seq: Sequence, upto_tokens: int) -> bool:
        """Append fresh pages until the table covers `upto_tokens` positions.
        Returns False if out of pages (caller preempts)."""
        P = self.page_size
        need = (upto_tokens + P - 1) // P
        while len(seq.block_table) < need:
            if not self.free:
                return False
            seq.block_table.append(self._take_page().page_id)
        return True

    def deallocate(self, seq: Sequence) -> None:
        for pid in reversed(seq.block_table):
            self._release_page(pid)
        seq.block_table = []
        seq.num_cached_tokens = 0

    def capacity_tokens(self, seq: Sequence) -> int:
        return len(seq.block_table) * self.page_size

"""Paged KV cache: page pool, free-list allocator, prefix registry and the
host page table (port of flexq_tpu/serve/paged.py).

KV lives in a pool of fixed-size pages [L, P, KVH, PS, D] (int8 pools add
f32 scale pools [L, P, KVH, PS]); a per-slot page table maps logical block
i to a pool page, so memory scales with live tokens, not slots x max_len.
The decode attention kernel follows the table (kernels/flash_decode.py::
flash_decode_paged): no gathered copy of the cache is made.

The reference's pool is immutable and updated by jitted donated scatters;
here the pool tensors are written in place, one indexed copy per buffer.
Data-parallel pool partitions are a later slice (``partitions`` must be 1).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.kernels.common import resolve_device


class PagePool:
    """Fixed pool of KV pages and its free-list allocator (the same order
    of ids as the reference: ``alloc`` hands out the lowest free id first
    on a fresh pool, and freed pages are reused last-in first-out)."""

    def __init__(self, num_layers: int, num_pages: int, kv_heads: int, page_size: int, head_dim: int,
                 dtype=torch.bfloat16, partitions: int = 1, device="cuda"):
        if partitions != 1:
            raise NotImplementedError("data-parallel pool partitions (PagePool(partitions > 1), a paged pool under "
                                      "dp > 1) are a later slice")
        if page_size % 128:
            raise ValueError(f"page size {page_size} must be a multiple of 128")
        device = resolve_device(device)  # the card unless the caller asks for the CPU, as the Engine's
        shape = (num_layers, num_pages, kv_heads, page_size, head_dim)
        self.page_size = page_size
        self.num_pages = num_pages
        self.quantized = dtype == torch.int8
        self.pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=device)
        if self.quantized:
            self.scale_k = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            self.scale_v = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        else:
            self.scale_k = self.scale_v = None
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if len(self._free) < n:
            raise MemoryError(f"page pool exhausted ({n} wanted, {len(self._free)} free)")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        self._free.extend(int(p) for p in pages)

    def pages_for(self, num_tokens: int) -> int:
        return -(-max(num_tokens, 1) // self.page_size)

    def _buffers(self):
        return [t for t in (self.pool_k, self.pool_v, self.scale_k, self.scale_v) if t is not None]

    def insert_prefill(self, pages: List[int], kv_k1, kv_v1, plen: int, ks1=None, vs1=None) -> None:
        """Copy a B=1 dense prefill cache region [L, 1, KVH, S, D] (scales
        [L, 1, KVH, S]) into the allocated pages: page i gets tokens
        [i*PS, (i+1)*PS). The region may extend past ``len(pages) * PS``
        (the scratch bucket); only that much is copied. Tokens of the last
        page past ``plen`` are copied too: they are never attended, and
        decode overwrites them."""
        n, ps = len(pages), self.page_size
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.pool_k.device)
        srcs = [kv_k1, kv_v1] + ([ks1, vs1] if self.quantized else [])
        for pool, x in zip(self._buffers(), srcs):
            r = x[:, 0, :, : n * ps]  # [L, KVH, n*PS(, D)]
            r = r.reshape(r.shape[:2] + (n, ps) + r.shape[3:]).transpose(1, 2)  # [L, n, KVH, PS(, D)]
            pool[:, idx] = r.to(pool.dtype)

    def gather_prefix(self, pages: List[int], scratch: Tuple) -> Tuple:
        """Fill a B=1 scratch cache's leading region from pool pages, in
        place: scratch = (k, v[, ks, vs]) with k/v [L, 1, KVH, S, D]; page i
        of ``pages`` lands at tokens [i*PS, (i+1)*PS). Returns ``scratch``."""
        m, ps = len(pages), self.page_size
        idx = torch.as_tensor(pages, dtype=torch.int64, device=self.pool_k.device)
        for pool, dst in zip(self._buffers(), scratch):
            r = pool[:, idx].transpose(1, 2)  # [L, KVH, m, PS(, D)]
            dst[:, 0, :, : m * ps] = r.reshape(r.shape[:2] + (m * ps,) + r.shape[4:]).to(dst.dtype)
        return scratch

    def copy_pages(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """pool[:, dst[i]] = pool[:, src[i]] for every buffer (the paged
        beam search's copy-on-divergence primitive)."""
        if not src:
            return
        dev = self.pool_k.device
        s = torch.as_tensor(list(src), dtype=torch.int64, device=dev)
        d = torch.as_tensor(list(dst), dtype=torch.int64, device=dev)
        for pool in self._buffers():
            pool[:, d] = pool[:, s]

    def state(self) -> Tuple:
        return tuple(self._buffers())

    def set_state(self, state: Tuple) -> None:
        if self.quantized:
            self.pool_k, self.pool_v, self.scale_k, self.scale_v = state
        else:
            self.pool_k, self.pool_v = state


class PrefixRegistry:
    """Content-addressed prompt-page cache (automatic prefix caching).

    A FULL prompt page is identified by the hash chain of every token from
    position 0 through its last token, so equal hashes imply identical K/V
    contents (RoPE is applied at absolute positions and shared prefixes
    start at 0). Pages in use carry a refcount; pages whose last user
    finished are RETAINED in an LRU instead of freed, and evicted back to
    the pool only under allocation pressure. Python's hash of a tuple of
    ints is deterministic, so the chains equal the reference's.
    """

    def __init__(self):
        self.by_hash: Dict[int, int] = {}  # chain hash -> page id
        self.page_hash: Dict[int, int] = {}  # page id -> chain hash
        self.rc: Dict[int, int] = {}  # page id -> active references
        self.retained: "OrderedDict[int, None]" = OrderedDict()  # rc == 0, LRU first
        self.hits = 0  # full-page reuse events
        self.misses = 0

    @staticmethod
    def hash_chain(tokens: Sequence[int], page_size: int) -> List[int]:
        """Chain hash per FULL page of the token sequence."""
        out: List[int] = []
        h = 0
        for i in range(len(tokens) // page_size):
            h = hash((h, tuple(tokens[i * page_size : (i + 1) * page_size])))
            out.append(h)
        return out

    def match(self, hashes: Sequence[int]) -> List[int]:
        """Longest run of already-cached pages for this hash chain (hits are
        counted in ``acquire``, after the caller's clamp)."""
        pages: List[int] = []
        for h in hashes:
            p = self.by_hash.get(h)
            if p is None:
                break
            pages.append(p)
        return pages

    def acquire(self, pages: Sequence[int]) -> None:
        self.hits += len(pages)
        for p in pages:
            self.rc[p] = self.rc.get(p, 0) + 1
            self.retained.pop(p, None)

    def account_miss(self, n: int) -> None:
        self.misses += max(n, 0)

    def register(self, h: int, page: int) -> bool:
        """Publish a freshly written full page. False when the hash is
        already published (the page then stays private to its slot)."""
        if h in self.by_hash:
            return False
        self.by_hash[h] = page
        self.page_hash[page] = h
        self.rc[page] = self.rc.get(page, 0) + 1
        return True

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that are not
        registered (the caller frees those). Registered pages whose count
        reaches 0 move to the retained LRU."""
        free_now: List[int] = []
        for p in pages:
            if p not in self.page_hash:
                free_now.append(p)
                continue
            self.rc[p] -= 1
            if self.rc[p] == 0:
                self.retained[p] = None
                self.retained.move_to_end(p)
        return free_now

    @property
    def reclaimable(self) -> int:
        return len(self.retained)

    def evict(self, n: int) -> List[int]:
        """Unregister up to n least recently retained pages; the caller
        frees them."""
        out: List[int] = []
        while self.retained and len(out) < n:
            p, _ = self.retained.popitem(last=False)
            del self.by_hash[self.page_hash.pop(p)]
            del self.rc[p]
            out.append(p)
        return out


class PageTable:
    """Host-managed per-slot page tables (int32 [slots, max_pages]); entry 0
    is the garbage page. ``to_device`` copies the table to the card once per
    step through a pinned buffer, on the current stream, so the copy lands
    before any kernel queued after it reads the table."""

    def __init__(self, num_slots: int, max_pages: int):
        self.table = np.zeros((num_slots, max_pages), np.int32)
        self.num_blocks = np.zeros(num_slots, np.int32)
        self._host = None  # pinned staging buffer (card only)
        self._dev = None
        self._copied = None  # event: the last copy out of the staging buffer is done

    def assign(self, slot: int, pages: List[int]) -> None:
        self.table[slot, : len(pages)] = pages
        self.table[slot, len(pages):] = 0
        self.num_blocks[slot] = len(pages)

    def append(self, slot: int, page: int) -> None:
        self.table[slot, self.num_blocks[slot]] = page
        self.num_blocks[slot] += 1

    def release(self, slot: int) -> List[int]:
        pages = [int(p) for p in self.table[slot, : self.num_blocks[slot]]]
        self.table[slot] = 0
        self.num_blocks[slot] = 0
        return pages

    def to_device(self, device: torch.device) -> torch.Tensor:
        """The table as an int32 tensor on ``device`` (for a CUDA device the
        same tensor each call, refreshed by an asynchronous copy)."""
        if device.type != "cuda":
            return torch.from_numpy(self.table.copy()).to(device)
        if self._dev is None:
            self._host = torch.empty(self.table.shape, dtype=torch.int32, pin_memory=True)
            self._dev = torch.empty(self.table.shape, dtype=torch.int32, device=device)
            self._copied = torch.cuda.Event()
        self._copied.synchronize()  # the previous copy has left the staging buffer
        self._host.numpy()[...] = self.table
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        return self._dev

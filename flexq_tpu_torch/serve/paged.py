"""Paged KV cache: page pool, free-list allocator, prefix registry and the
host page table (port of flexq_tpu/serve/paged.py).

KV lives in a pool of fixed-size pages [L, P, KVH, PS, D] (int8 pools add
f32 scale pools [L, P, KVH, PS]); a per-slot page table maps logical block
i to a pool page, so memory scales with live tokens, not slots x max_len.
The decode attention kernel follows the table (kernels/flash_decode.py::
flash_decode_paged): no gathered copy of the cache is made.

The reference's pool is immutable and updated by jitted donated scatters;
here the pool tensors are written in place, one indexed copy per buffer.
Under data parallelism the pool splits into partitions, one a data rank
(``PagePool(partitions=dp, partition=d)``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexq_tpu_torch.kernels.common import resolve_device


class PagePool:
    """Fixed pool of KV pages and its free-list allocator (the same order
    of ids as the reference: ``alloc`` hands out the lowest free id first
    on a fresh pool, and freed pages are reused last-in first-out).

    ``partitions`` > 1 splits the page space into data-parallel shards:
    partition d owns the global ids [d·P/dp, (d+1)·P/dp) and allocates only
    from them. The allocator's bookkeeping (global ids) is the same on
    every rank, as the scheduler's is; a page table goes to the device
    localized (``localize``: global % P/dp, so unmapped entries land on each
    partition's own garbage page, its local page 0). With ``partition``
    (one process per data rank) the device buffers hold only that
    partition's P/dp pages, and the copies into and out of them take global
    ids of that partition; without it they hold all P pages, as the
    reference's one process does."""

    def __init__(self, num_layers: int, num_pages: int, kv_heads: int, page_size: int, head_dim: int,
                 dtype=torch.bfloat16, partitions: int = 1, device="cuda", partition: Optional[int] = None):
        if page_size % 128:
            raise ValueError(f"page size {page_size} must be a multiple of 128")
        if partitions < 1 or num_pages % partitions:
            raise ValueError(f"{num_pages} pages do not split into {partitions} equal partitions")
        if partition is not None and not 0 <= partition < partitions:
            raise ValueError(f"partition {partition} of {partitions}")
        device = resolve_device(device)  # the card unless the caller asks for the CPU, as the Engine's
        self.page_size = page_size
        self.num_pages = num_pages
        self.partitions = partitions
        self.pages_per_partition = ppp = num_pages // partitions
        self.partition = partition
        shape = (num_layers, num_pages if partition is None else ppp, kv_heads, page_size, head_dim)
        self.quantized = dtype == torch.int8
        self.pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=device)
        if self.quantized:
            self.scale_k = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
            self.scale_v = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        else:
            self.scale_k = self.scale_v = None
        self._free: List[List[int]] = [list(range((d + 1) * ppp - 1, d * ppp - 1, -1)) for d in range(partitions)]

    @property
    def free_pages(self) -> int:
        return sum(len(f) for f in self._free)

    def free_in(self, part: int) -> int:
        return len(self._free[part])

    def alloc(self, n: int = 1, part: int = 0) -> List[int]:
        """n pages of partition ``part`` (global ids)."""
        free = self._free[part]
        if len(free) < n:
            raise MemoryError(f"page pool exhausted ({n} wanted, {len(free)} free in partition {part})")
        return [free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            self._free[int(p) // self.pages_per_partition].append(int(p))

    def localize(self, table: np.ndarray) -> np.ndarray:
        """A table of global page ids as each partition's device pool reads
        it (the identity for one partition)."""
        return table if self.partitions == 1 else table % self.pages_per_partition

    def _index(self, pages) -> torch.Tensor:
        """Global page ids as indices into the device buffers."""
        pages = [int(p) for p in pages]
        if self.partition is not None:
            lo = self.partition * self.pages_per_partition
            if any(not lo <= p < lo + self.pages_per_partition for p in pages):
                raise ValueError(f"pages {pages} are not all in partition {self.partition}, the one this pool holds")
            pages = [p - lo for p in pages]
        return torch.as_tensor(pages, dtype=torch.int64, device=self.pool_k.device)

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
        idx = self._index(pages)
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
        idx = self._index(pages)
        for pool, dst in zip(self._buffers(), scratch):
            r = pool[:, idx].transpose(1, 2)  # [L, KVH, m, PS(, D)]
            dst[:, 0, :, : m * ps] = r.reshape(r.shape[:2] + (m * ps,) + r.shape[4:]).to(dst.dtype)
        return scratch

    def copy_pages(self, src: Sequence[int], dst: Sequence[int]) -> None:
        """pool[:, dst[i]] = pool[:, src[i]] for every buffer (the paged
        beam search's copy-on-divergence primitive)."""
        if not src:
            return
        s, d = self._index(src), self._index(dst)
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

    def to_device(self, device: torch.device, localize=None) -> torch.Tensor:
        """The table as an int32 tensor on ``device`` (for a CUDA device the
        same tensor each call, refreshed by an asynchronous copy), through
        ``localize`` (a pool's ``localize``) where given."""
        table = self.table if localize is None else localize(self.table)
        if device.type != "cuda":
            return torch.from_numpy(np.array(table, dtype=np.int32)).to(device)
        if self._dev is None:
            self._host = torch.empty(self.table.shape, dtype=torch.int32, pin_memory=True)
            self._dev = torch.empty(self.table.shape, dtype=torch.int32, device=device)
            self._copied = torch.cuda.Event()
        self._copied.synchronize()  # the previous copy has left the staging buffer
        self._host.numpy()[...] = table
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        return self._dev

"""Structural invariants of the paged KV block pool.

Port of ``repro.serving.invariants``: the device pool and the host-RAM
tier under it.
:func:`assert_pool_invariants` holds at any step boundary — mid-serve
with live rows or fully drained — because the allocator keeps every
property below at all times:

  * refcount conservation: ``_refcnt[blk]`` equals the number of
    block-table cells referencing ``blk`` across all rows;
  * partition: every pool block is in exactly one of {free list, LRU,
    referenced by a table}; the trash block 0 is in none of them;
  * free-list integrity: no duplicates, disjoint from tables and LRU;
  * LRU membership: only refcount-0 *hashed* blocks are retained;
  * index consistency: ``_prefix_index`` (digest → block) and
    ``_block_hash`` (block → digest set) are exact inverses, and every
    hashed block is resident (live or LRU);
  * reservation accounting: ``_avail`` equals free + LRU minus the
    outstanding reservations and is never negative; empty rows hold no
    reservation and no blocks;
  * host tier: a digest resolves to a device block or a host entry,
    never both; ``_host_index`` (digest → entry) and the store's digest
    sets are exact inverses with no empty entry; ``host_bytes`` equals
    the entries' bytes and stays within ``host_pool_bytes``; with the
    tier off the host state is empty.
"""
from __future__ import annotations

import collections


def assert_pool_invariants(sched) -> None:
    """Assert the paged-pool invariants on a ContinuousScheduler (a no-op
    for the contiguous cache and the recurrent state). Raises
    AssertionError naming the first violated property."""
    if not getattr(sched, "paged", False):
        return
    tab = sched._block_tab
    refs = collections.Counter(int(blk) for blk in tab[tab >= 0])

    assert 0 not in refs, "trash block 0 mapped into a live block table"
    for blk in range(1, sched.pool_blocks + 1):
        assert int(sched._refcnt[blk]) == refs.get(blk, 0), (
            f"refcount drift on block {blk}: refcnt={int(sched._refcnt[blk])} "
            f"but {refs.get(blk, 0)} table refs")
    assert int(sched._refcnt[0]) == 0, "trash block 0 has a refcount"

    free = list(sched._free)
    fs, lru, live = set(free), set(sched._lru), set(refs)
    assert len(fs) == len(free), "free list holds duplicate blocks"
    assert 0 not in fs and 0 not in lru, "trash block 0 in free list / LRU"
    assert not fs & live, f"free blocks still referenced: {sorted(fs & live)}"
    assert not fs & lru, f"blocks both free and LRU-retained: {sorted(fs & lru)}"
    assert not lru & live, f"LRU blocks still referenced: {sorted(lru & live)}"
    every = set(range(1, sched.pool_blocks + 1))
    assert fs | lru | live == every, (
        f"pool partition leak: lost blocks {sorted(every - fs - lru - live)}")

    for blk in lru:
        assert blk in sched._block_hash, (
            f"LRU retains unhashed block {blk} (nothing could ever hit it)")

    assert len(sched._prefix_index) == sum(
        len(hs) for hs in sched._block_hash.values()), (
        "prefix index / block-hash map size mismatch")
    for h, blk in sched._prefix_index.items():
        assert h in sched._block_hash.get(blk, ()), (
            f"prefix index entry missing from block {blk}'s digest set")
    for blk, hs in sched._block_hash.items():
        assert hs, f"block {blk} hashed with an empty digest set"
        for h in hs:
            assert sched._prefix_index.get(h) == blk, (
                f"digest on block {blk} not indexed back to it")
        assert blk in live or blk in lru, (
            f"hashed block {blk} is neither live nor LRU-retained")

    assert (sched._reserved >= 0).all(), "negative per-row reservation"
    for b, req in enumerate(sched._slots):
        if req is None:
            assert int(sched._reserved[b]) == 0, f"empty row {b} holds a reservation"
            assert (tab[b] == -1).all(), f"empty row {b} still maps blocks"
    assert sched._avail == len(free) + len(lru) - int(sched._reserved.sum()), (
        f"_avail drift: {sched._avail} != {len(free)} free + {len(lru)} LRU "
        f"- {int(sched._reserved.sum())} reserved")
    assert sched._avail >= 0, "negative available-capacity accounting"

    # -- the host-RAM tier ----------------------------------------------------
    store = sched._host_store
    if not sched.host_tier:
        assert not store and not sched._host_index and not sched.host_bytes, (
            "host tier disabled but host state is non-empty")
        return
    for hid, entry in store.items():
        assert entry.digests, f"host entry {hid} holds an empty digest set"
        for h in entry.digests:
            assert sched._host_index.get(h) == hid, (
                f"digest on host entry {hid} not indexed back to it")
            assert h not in sched._prefix_index, (
                f"digest resolves to both device block "
                f"{sched._prefix_index.get(h)} and host entry {hid}")
    assert len(sched._host_index) == sum(len(e.digests) for e in store.values()), (
        "host index / host store digest-count mismatch")
    for h, hid in sched._host_index.items():
        assert hid in store, f"host index points at evicted entry {hid}"
    got = sum(e.nbytes for e in store.values())
    assert sched.host_bytes == got, (
        f"host_bytes drift: tracked {sched.host_bytes} != resident {got}")
    assert sched.host_bytes <= sched.host_pool_bytes, (
        f"host tier over budget: {sched.host_bytes} > {sched.host_pool_bytes}")

"""Per-slot recurrent-state bookkeeping for hybrid SSM/recurrent serving.

Attention state is O(tokens) and lives in the paged pool; recurrent state
(mamba's conv tail + SSM ``h``, rgLRU's hidden ``h`` + conv tail) is O(1)
per sequence — the degenerate case of sliding-window reclamation where the
"window" is a single carried state.  The device side is one fixed row per
decode slot in every recurrent layer's cache (plus one trailing *trash row*
that absorbs padding-token gathers/scatters, mirroring the pool's trash
page); this class owns the host side: which slots hold live state, which
are free, and which were just released and must never be read again.

Lifecycle is driven by :class:`~repro.serving.paged_cache.BlockTables` —
``admit`` / ``release`` there call ``admit`` / ``release`` here, so the
scheduler's existing admission/eviction/preemption decisions manage
recurrent state with no extra policy.  Correctness does **not** depend on
host-side zeroing: a prefill span starting at position 0 always injects a
fresh zero initial state on device, so a re-admitted slot's stale state is
dead by construction.  ``drain_released`` exists for the engine's
``poison_reclaimed`` test hook, which clobbers released rows with a huge
constant so any read of dead state corrupts generations instead of passing
silently.

Conservation invariant (fuzz-tested in tests/test_paged.py):
``num_free + num_occupied == capacity`` with the two sets disjoint.

Plain python only — this module is part of the serving host layer
(sparklint's ``host-layer-numpy-only`` rule covers it): no jax imports, no
device buffers, nothing that could trace or recompile per queue shape.
"""

from __future__ import annotations

from typing import List


class StateCache:
    """Host bookkeeping for the fixed per-slot recurrent-state rows.

    ``capacity`` equals the engine's ``max_batch``: state row ``i`` on
    device backs decode slot ``i`` (the device arrays carry one extra
    trailing trash row this class never tracks).
    """

    def __init__(self, capacity: int):
        assert capacity >= 1, "need at least one state slot"
        self.capacity = capacity
        self._free = set(range(capacity))
        self._occupied = set()
        self._released: List[int] = []   # drained by the engine's poison hook
        self.admits = 0
        self.releases = 0

    @property
    def num_free(self) -> int:
        """Slots whose state row is dead (writable by the next admission)."""
        return len(self._free)

    @property
    def num_occupied(self) -> int:
        """Slots whose state row backs a live sequence."""
        return len(self._occupied)

    def occupied(self, slot: int) -> bool:
        """Is this slot's state row live?"""
        return slot in self._occupied

    def free_slot_ids(self) -> List[int]:
        """Snapshot of the free slots (state rows that are dead).  The
        chaos harness's ``poison`` fault clobbers exactly these rows to
        prove released recurrent state is never read back."""
        return sorted(self._free)

    def admit(self, slot: int):
        """Mark a slot's state row live.  Raises on a slot outside the
        capacity or already occupied (the double-admit that would silently
        smear two sequences' recurrent state)."""
        if not 0 <= slot < self.capacity:
            raise ValueError(f"state slot {slot} outside capacity "
                             f"{self.capacity}")
        if slot in self._occupied:
            raise ValueError(f"state slot {slot} is already occupied — "
                             f"double admit")
        self._free.remove(slot)
        self._occupied.add(slot)
        self.admits += 1

    def release(self, slot: int):
        """Mark a slot's state row dead (finish, EOS, or preemption) and
        queue it for :meth:`drain_released`.  Raises on a slot that is not
        occupied (double release / never admitted)."""
        if slot not in self._occupied:
            raise ValueError(f"state slot {slot} is not occupied — double "
                             f"release or never admitted")
        self._occupied.remove(slot)
        self._free.add(slot)
        self._released.append(slot)
        self.releases += 1

    def drain_released(self) -> List[int]:
        """Take the slots released since the last drain (in release order).
        The engine's ``poison_reclaimed`` hook clobbers these rows on
        device; a drained slot may already be re-admitted, in which case
        poisoning is still safe — re-admission re-prefills from position 0,
        which injects a fresh zero state without reading the row."""
        out = self._released
        self._released = []
        return out

"""The serving engine's slot scheduler: native C++ behind ctypes, and its
plain Python version.

``scheduler.cpp`` (a copy of the JAX package's) keeps a FIFO queue of
requests and a fixed pool of decode slots: admission under a token budget
(prompt + max_new of every live request), slot lifecycle, per-slot token
counts, and a byte snapshot for fail-stop recovery.  ``ops/build.py``
compiles it with the host C++ compiler into ``scope_tpu_torch/_build/`` at
first use; a failed build raises.  :class:`PySlotScheduler` is the same
state machine in Python, the plain version the tests hold the native one
against.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

from scope_tpu_torch.ops import build

_SOURCE = "scheduler.cpp"
_c = ctypes
_SIGNATURES = {
    "scope_sched_create": ([_c.c_int32, _c.c_int64, _c.c_int32], _c.c_void_p),
    "scope_sched_destroy": ([_c.c_void_p], None),
    "scope_sched_submit": ([_c.c_void_p, _c.c_int32, _c.c_int32], _c.c_int64),
    "scope_sched_admit": ([_c.c_void_p, _c.POINTER(_c.c_int64),
                           _c.POINTER(_c.c_int32), _c.POINTER(_c.c_int32)],
                          _c.c_int32),
    "scope_sched_step": ([_c.c_void_p, _c.c_int32], _c.c_int32),
    "scope_sched_finish": ([_c.c_void_p, _c.c_int32], _c.c_int64),
    "scope_sched_active": ([_c.c_void_p], _c.c_int32),
    "scope_sched_queued": ([_c.c_void_p], _c.c_int32),
    "scope_sched_live_tokens": ([_c.c_void_p], _c.c_int64),
    "scope_sched_snapshot": ([_c.c_void_p, _c.c_char_p, _c.c_int64],
                             _c.c_int64),
    "scope_sched_restore": ([_c.c_void_p, _c.c_char_p, _c.c_int64],
                            _c.c_int32),
}


def load_scheduler() -> ctypes.CDLL:
    """The scheduler's library, built first if needed, with every entry
    point's signature declared."""
    lib = build.load(_SOURCE)
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


class SlotScheduler:
    """Continuous-batching slot scheduler on the native library."""

    def __init__(self, max_slots: int, token_budget: int,
                 queue_cap: int = 4096):
        self._lib = load_scheduler()
        self.max_slots = max_slots
        self._h = self._lib.scope_sched_create(max_slots, token_budget,
                                               queue_cap)
        if not self._h:
            raise MemoryError("scope_sched_create failed")

    def submit(self, prompt_len: int, max_new: int) -> int:
        """Queue a request; its id, or -1 when the queue is full."""
        return int(self._lib.scope_sched_submit(self._h, prompt_len,
                                                max_new))

    def admit(self) -> Optional[Tuple[int, int, int, int]]:
        """(slot, request_id, prompt_len, max_new) of the next queued
        request given a slot, or None (empty queue, no free slot, or the
        token budget would be exceeded)."""
        rid, pl, mn = _c.c_int64(), _c.c_int32(), _c.c_int32()
        slot = self._lib.scope_sched_admit(self._h, _c.byref(rid),
                                           _c.byref(pl), _c.byref(mn))
        if slot < 0:
            return None
        return int(slot), int(rid.value), int(pl.value), int(mn.value)

    def step(self, slot: int) -> bool:
        """Count one generated token; True if the slot hit max_new."""
        return bool(self._lib.scope_sched_step(self._h, slot))

    def finish(self, slot: int) -> int:
        """Free a slot; its request id, or -1 if it was free."""
        return int(self._lib.scope_sched_finish(self._h, slot))

    @property
    def active(self) -> int:
        return int(self._lib.scope_sched_active(self._h))

    @property
    def queued(self) -> int:
        return int(self._lib.scope_sched_queued(self._h))

    @property
    def live_tokens(self) -> int:
        return int(self._lib.scope_sched_live_tokens(self._h))

    def snapshot(self) -> bytes:
        """Opaque state for fail-stop recovery (``ServingEngine.snapshot``)."""
        need = self._lib.scope_sched_snapshot(self._h, None, 0)
        buf = _c.create_string_buffer(int(need))
        got = self._lib.scope_sched_snapshot(self._h, buf, need)
        if got != need:
            raise RuntimeError(f"scheduler snapshot wrote {got} of {need} "
                               f"bytes")
        return buf.raw

    def restore(self, snap: bytes) -> None:
        if self._lib.scope_sched_restore(self._h, snap, len(snap)) != 0:
            raise ValueError("scheduler snapshot does not fit this "
                             "scheduler (slot count or queue size)")

    def close(self) -> None:
        if self._h:
            self._lib.scope_sched_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class PySlotScheduler:
    """The plain version of :class:`SlotScheduler`: the same state machine
    in Python (FIFO queue of ``queue_cap``, first free slot, token budget),
    with a snapshot of Python objects instead of bytes."""

    def __init__(self, max_slots: int, token_budget: int,
                 queue_cap: int = 4096):
        self.max_slots = max_slots
        self._budget = token_budget
        self._cap = queue_cap
        self._queue: List[Tuple[int, int, int]] = []
        # Per slot: [request id, prompt_len, max_new, generated] or None.
        self._slots: List[Optional[list]] = [None] * max_slots
        self._live = 0
        self._next = 1

    def submit(self, prompt_len: int, max_new: int) -> int:
        if len(self._queue) >= self._cap:
            return -1
        rid = self._next
        self._next += 1
        self._queue.append((rid, prompt_len, max_new))
        return rid

    def admit(self) -> Optional[Tuple[int, int, int, int]]:
        if not self._queue:
            return None
        rid, pl, mn = self._queue[0]
        if self._live + pl + mn > self._budget:
            return None
        for i, s in enumerate(self._slots):
            if s is None:
                self._queue.pop(0)
                self._slots[i] = [rid, pl, mn, 0]
                self._live += pl + mn
                return i, rid, pl, mn
        return None

    def step(self, slot: int) -> bool:
        s = self._slots[slot]
        if s is None:
            return False
        s[3] += 1
        return s[3] >= s[2]

    def finish(self, slot: int) -> int:
        s = self._slots[slot]
        if s is None:
            return -1
        self._slots[slot] = None
        self._live -= s[1] + s[2]
        return s[0]

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def live_tokens(self) -> int:
        return self._live

    def snapshot(self):
        return (list(self._queue), [None if s is None else list(s)
                                    for s in self._slots],
                self._live, self._next)

    def restore(self, snap) -> None:
        q, slots, self._live, self._next = snap
        if len(slots) != self.max_slots or len(q) > self._cap:
            raise ValueError("scheduler snapshot does not fit this "
                             "scheduler (slot count or queue size)")
        self._queue = list(q)
        self._slots = [None if s is None else list(s) for s in slots]

"""Host-to-card copies through pinned staging: two slots of pinned host
memory on a side stream, so that the host's copy into one slot overlaps
the DMA out of the other. The streamed loaders (streaming.Loader) copy
their chunks through it, and the in-core upload (sparse.DocSparse.
from_corpus) copies the corpus's word ids and values through it by
entry ranges (upload).

On a CPU device a Staging pins nothing and copies at once, so that its
host side (the slots, the entry ranges, the slices written) runs
without a card.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import torch

# entries a chunk of the streamed loaders and of the in-core upload's
# staging: 128 MB a slot for int32 word ids and float32 values
DEFAULT_CHUNK_ENTRIES = 1 << 24


class _Slot:
    """One of the two staging slots: a host buffer for each field (pinned
    on a card), the fields' device buffers where the slot has its own,
    and the event of the slot's last copy (none on the CPU)."""

    def __init__(self, cap: int, dtypes, device: torch.device, own: bool):
        cuda = device.type == "cuda"
        self.pin = [torch.empty(cap, dtype=dt, pin_memory=cuda)
                    for dt in dtypes]
        self.dev = ([torch.empty(cap, dtype=dt, device=device)
                     for dt in dtypes] if own else [])
        self.copied = torch.cuda.Event() if cuda else None


class Staging:
    """Two slots of `cap` entries of each of `dtypes`, and a side stream
    on `device`. stage() copies host tensors through the next slot; a
    copy starts after the work enqueued so far on the current stream
    (which holds the last reader of a slot's device buffers). The host
    memory is freed with the object (PyTorch's host allocator keeps it
    for the process's next pinned buffers)."""

    def __init__(self, cap: int, dtypes: Sequence[torch.dtype], device,
                 own: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.slots: List[_Slot] = [_Slot(cap, dtypes, self.device, own)
                                   for _ in range(2)]
        self._turn = 0

    def stage(self, srcs, dsts=None) -> Tuple[_Slot, float]:
        """Copy the host tensors `srcs` (one length) into the device
        tensors `dsts`, else into the next slot's own buffers. Returns
        the slot and the seconds the host waited for it to be free."""
        slot = self.slots[self._turn]
        self._turn ^= 1
        n = srcs[0].numel()
        if n > slot.pin[0].numel():
            raise ValueError(f"{n} entries are more than a slot holds "
                             f"({slot.pin[0].numel()})")
        t0 = time.perf_counter()
        if slot.copied is not None:
            slot.copied.synchronize()  # the staging buffers are free again
        waited = time.perf_counter() - t0
        for p, src in zip(slot.pin, srcs):
            p[:n].copy_(src)
        outs = slot.dev if dsts is None else dsts
        if not self.cuda:
            for d, p in zip(outs, slot.pin):
                d[:n].copy_(p[:n])
            return slot, waited
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for d, p in zip(outs, slot.pin):
                d[:n].copy_(p[:n], non_blocking=True)
            slot.copied.record(self.stream)
        return slot, waited

    def finish(self) -> None:
        """Wait on the host for every copy staged, and make the current
        stream wait for them."""
        if self.cuda:
            self.stream.synchronize()
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def upload(srcs, dsts, chunk_entries: int = DEFAULT_CHUNK_ENTRIES) -> int:
    """Copy host tensors `srcs` (one length) into the tensors `dsts` on
    their device, by entry ranges of `chunk_entries` through a Staging,
    and return once every copy has ended. A range may end anywhere: the
    entries need no boundary of their own. Returns the bytes staged."""
    n = srcs[0].numel()
    if n == 0:
        return 0
    cap = min(int(chunk_entries), n)
    st = Staging(cap, [s.dtype for s in srcs], dsts[0].device)
    for a in range(0, n, cap):
        b = min(a + cap, n)
        st.stage([s[a:b] for s in srcs], [d[a:b] for d in dsts])
    st.finish()
    return n * sum(s.element_size() for s in srcs)

"""What a step reads from the host, written to the device in one copy.

A training step draws some of its randomness on the host (the kernels'
Philox seed pairs, LayerDrop, SpecAugment's spans, the SER trunks'
dropout masks) and takes its optimizer scalars from the host (the LR and
Adam's bias corrections).  A CUDA graph of the step freezes every host
value and may not copy from the host inside it, so each of these lives in
a slot of a :class:`Staging`: a static device buffer that the step reads in
place, and a pinned host buffer of the same layout that the host fills
before each step and copies over in one ``copy_``.  The eager step reads
the same slots, so both forms see the same bits.

Protocol, once a step: :meth:`Staging.begin` (waits until the previous
step's copy has left the pinned buffer, so the host never overwrites bytes
still in flight; the thread sleeps there rather than spin, since a host
that runs a step ahead of the card waits here for most of a step), write
the slots through :meth:`Staging.host`, then
:meth:`Staging.push` (one asynchronous copy on the current stream, ordered
after the previous step's kernels, which read the device buffer, and
before this step's).  On the CPU the host and device views are one
buffer, and both calls do nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ALIGN = 16  # bytes: every slot starts on a 16-byte boundary


class Staging:
    """Named slots ``{name: (shape, dtype)}`` in one device byte buffer on
    ``device`` and one pinned host buffer (the same buffer on the CPU)."""

    def __init__(self, device, slots: Dict[str, Tuple[Tuple[int, ...],
                                                      torch.dtype]]):
        self.device = torch.device(device)
        layout, off = {}, 0
        for name, (shape, dtype) in slots.items():
            shape = tuple(int(d) for d in shape)
            size = int(np.prod(shape)) * torch.empty(
                (), dtype=dtype).element_size()
            layout[name] = (off, size, shape, dtype)
            off += -(-size // ALIGN) * ALIGN
        self.nbytes = max(off, ALIGN)
        on_card = self.device.type == "cuda"
        self._host_buf = torch.zeros(self.nbytes, dtype=torch.uint8,
                                     pin_memory=on_card)
        self._dev_buf = torch.zeros(self.nbytes, dtype=torch.uint8,
                                    device=self.device) if on_card \
            else self._host_buf
        self._host = {n: _view(self._host_buf, *v) for n, v in layout.items()}
        self._dev = {n: _view(self._dev_buf, *v) for n, v in layout.items()}
        self._copied = None  # the event after the last copy

    def host(self, name: str) -> torch.Tensor:
        """The slot's host view, written before :meth:`push`."""
        return self._host[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        """The slot's device view: a static address the step reads."""
        return self._dev[name]

    def begin(self) -> None:
        """Wait until the previous :meth:`push` has left the host buffer."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    def push(self) -> None:
        """Copy the host buffer to the device buffer on the current stream
        (nothing on the CPU)."""
        if self._dev_buf is self._host_buf:
            return
        self._dev_buf.copy_(self._host_buf, non_blocking=True)
        self._copied = torch.cuda.Event(blocking=True)
        self._copied.record()


def _view(buf: torch.Tensor, off: int, size: int, shape, dtype):
    return buf[off:off + size].view(dtype).view(shape)

"""Host-to-device feed of wire batches (replaces the jax.device_put stage of
ntcard_tpu/pipeline.py:466-531).

Decode and pack run in ntcard_tpu's native packer on a background thread
(ntcard_tpu.pipeline.prefetch); each wire batch is copied into a pinned host
buffer and sent to the card with a non-blocking copy on the current stream,
so the copy of batch i+1 overlaps the kernels of batch i. A ring of pinned
buffers is reused; before a buffer is refilled, the host waits for the event
recorded after its last copy.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from ntcard_tpu.pipeline import prefetch

RING = 3  # pinned buffers: one being filled, one in flight, one spare


def device_feed(batches: Iterable[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Yield each numpy batch as a tensor on ``device`` (decode runs ahead
    on a background thread). On the CPU the tensor shares the batch's
    memory."""
    if device.type != "cuda":
        for b in prefetch(batches):
            yield torch.from_numpy(b)
        return
    ring: list = [None] * RING  # (pinned host tensor, event of its last copy)
    for i, b in enumerate(prefetch(batches)):
        slot = ring[i % RING]
        if slot is None or slot[0].shape != b.shape:
            slot = (torch.empty(b.shape, dtype=torch.uint8, pin_memory=True), torch.cuda.Event())
            ring[i % RING] = slot
        else:
            slot[1].synchronize()  # its previous copy to the card has finished
        host, done = slot
        host.numpy()[...] = b
        dev = host.to(device, non_blocking=True)
        done.record()
        yield dev

"""Host-to-device prefetch of training batches, the port of
`sp_gan_tpu/data/prefetch.py`: the streaming path of a dataset too large
to keep on the device.

Up to `size` batches are staged ahead of the one yielded, on every device,
so that the host iterator is drawn from alike on the card and on the CPU.
On a CUDA device staging copies the host batch into pinned memory and sends
it with `non_blocking=True` on a side stream; before a batch is yielded the
consumer's current stream waits on its copy's event and the tensor is
recorded as used on that stream, so no batch is read before its copy lands
and the allocator does not reuse its memory while the consumer may still
read it. On the CPU staging makes the tensor.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from sp_gan_tpu_torch.device import resolve_device


def prefetch_to_device(iterator: Iterable[np.ndarray], size: int = 2,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Iterator[torch.Tensor]:
    """f32 tensors on `device` (default cuda) from an iterator of host
    batches, in order, with up to `size` batches staged (on CUDA, copies
    in flight)."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    device = resolve_device(device)
    queue = collections.deque()
    if device.type == "cuda":
        side = torch.cuda.Stream(device)

        def stage(batch):
            host = torch.from_numpy(np.ascontiguousarray(batch, np.float32)) \
                .pin_memory()
            with torch.cuda.stream(side):
                dev_batch = host.to(device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            # the pinned buffer stays referenced until its copy has landed
            return dev_batch, host, copied

        def land(staged):
            dev_batch, _host, copied = staged
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            dev_batch.record_stream(consumer)
            return dev_batch
    else:
        def stage(batch):
            return torch.as_tensor(np.asarray(batch, np.float32),
                                   device=device)

        def land(staged):
            return staged

    for batch in iterator:
        queue.append(stage(batch))
        if len(queue) >= size:
            yield land(queue.popleft())
    while queue:
        yield land(queue.popleft())

"""Background batch prefetching (PyTorch counterpart of
``instance_nerf_tpu.data.prefetch``): a thread builds the next batches
(npz decode, augmentation, padding) while the card runs the step.
"""
from __future__ import annotations

import queue
import threading


class PrefetchLoader:
    """Wrap ``make_batch(step_index) -> batch`` with ``lookahead`` batches
    built ahead on a thread. Iterating yields ``num_steps`` batches in
    order; an error in ``make_batch`` is raised in the consumer at the
    batch where it happened.

        for batch in PrefetchLoader(make_batch, num_steps, lookahead=2):
            ...
    """

    def __init__(self, make_batch, num_steps: int, lookahead: int = 2):
        self.make_batch = make_batch
        self.num_steps = num_steps
        self.q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for i in range(self.num_steps):
                self.q.put(self.make_batch(i))
        except Exception as e:  # raised by the consumer at the next batch
            self._err = e
        finally:
            self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item

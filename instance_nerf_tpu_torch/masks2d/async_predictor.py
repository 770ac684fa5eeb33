"""Asynchronous multi-worker 2D predictor (a copy of
``instance_nerf_tpu.masks2d.async_predictor``, which imports no JAX).

Capability parity with the reference's ``AsyncPredictor``
(Mask2Former_sample/predictor.py:17-220): it spawns one CUDA process per
GPU with task/result queues so 2D mask inference overlaps across devices
and with host-side image IO. Here the workers are THREADS (torch releases
the GIL while the device runs), each owning its own predictor instance,
with submission-order result delivery.

Used by ``run_mask2former.py --num_workers N`` to overlap per-view
preprocessing, model inference, and .npy/.json writing.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator


class _StopToken:
    pass


class AsyncPredictor:
    """Run ``predictor(task)`` on worker threads, yielding results in
    submission order (the reference's put/get contract,
    predictor.py:130-170).

    Args:
      make_predictor: factory called once per worker (worker index) ->
        callable. Lets each worker bind its own device / model replica.
      num_workers: worker thread count (reference: #GPUs).
      queue_size: max in-flight tasks (reference: 3 per worker).
    """

    def __init__(self, make_predictor: Callable[[int], Callable[[Any], Any]],
                 num_workers: int = 1, queue_size: int | None = None):
        assert num_workers >= 1
        self._task_q: queue.Queue = queue.Queue(
            maxsize=queue_size or 3 * num_workers)
        self._result_q: queue.Queue = queue.Queue()
        self._put_idx = 0
        self._get_idx = 0
        self._result_buf: dict[int, Any] = {}
        self._threads = []
        self._errors: queue.Queue = queue.Queue()
        for w in range(num_workers):
            t = threading.Thread(
                target=self._worker, args=(w, make_predictor), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _worker(self, widx: int, make_predictor):
        try:
            predictor = make_predictor(widx)
        except Exception as e:  # noqa: BLE001
            self._errors.put(e)
            return
        while True:
            item = self._task_q.get()
            if isinstance(item, _StopToken):
                return
            idx, task = item
            try:
                self._result_q.put((idx, predictor(task)))
            except Exception as e:  # noqa: BLE001
                self._errors.put(e)
                self._result_q.put((idx, e))

    def put(self, task):
        self._task_q.put((self._put_idx, task))
        self._put_idx += 1

    def get(self):
        """Next result in submission order (blocks)."""
        want = self._get_idx
        self._get_idx += 1
        while want not in self._result_buf:
            idx, res = self._result_q.get()
            self._result_buf[idx] = res
        res = self._result_buf.pop(want)
        if isinstance(res, Exception):
            raise res
        return res

    def __call__(self, task):
        self.put(task)
        return self.get()

    def imap(self, tasks: Iterable[Any]) -> Iterator[Any]:
        """Pipelined map preserving order: keeps the task queue full
        while yielding completed results."""
        tasks = iter(tasks)
        pending = 0
        capacity = self._task_q.maxsize
        for t in tasks:
            self.put(t)
            pending += 1
            while pending >= capacity:
                yield self.get()
                pending -= 1
        while pending:
            yield self.get()
            pending -= 1

    def shutdown(self):
        for _ in self._threads:
            self._task_q.put(_StopToken())
        for t in self._threads:
            t.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

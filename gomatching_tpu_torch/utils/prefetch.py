"""Bounded background-thread prefetch for lazy frame streams (the port's copy of
gomatching_tpu/utils/prefetch.py).

The video inference CLI decodes frames lazily (host memory stays O(window) for
arbitrarily long videos, ``engine/predictor.process_video``), but a plain generator
decodes each JPEG on the consumer thread, between device calls. ``prefetch_iter``
moves decoding to a daemon thread behind a bounded queue: cv2.imread releases the GIL
in its C core, so decode overlaps the device work and the host tracker. Order is
preserved; a producer exception re-raises at the consumer's next pull.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_iter(it: Iterable, depth: int = 128) -> Iterator:
    """Iterate ``it`` on a background thread, up to ``depth`` items ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))

    def produce():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    t = threading.Thread(target=produce, daemon=True)
    t.start()

    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item

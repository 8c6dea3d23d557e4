"""Multi-LIDAR cloud accumulation (reference layer L4).

Ports the state machine of ``CloudAccumulationLogic`` /
``CloudAccumulationLogicPassThrough`` (src/cloud_accum.cpp:41-125):
clouds from multiple sensors are accumulated round-robin, keyed by
frame_id, until the first-seen key has arrived ``accum`` times; then the
batch is processed and accumulation restarts with the triggering cloud.
An overflow guard force-processes if a sensor dies
(src/cloud_accum.cpp:101-107).

Host-side logic over callbacks — not performance-critical.
"""

from __future__ import annotations

from typing import Callable


class CloudAccumulationPassThrough:
    """accum_cloud == 0: process every cloud (src/cloud_accum.cpp:41-51)."""

    def push(self, key: str, msg, process: Callable[[], None],
             accumulate: Callable[[object], bool],
             clear: Callable[[], None]) -> None:
        clear()
        if accumulate(msg):
            process()

    def reset(self) -> None:
        pass


class CloudAccumulation:
    """Round-accumulation policy (src/cloud_accum.cpp:53-125)."""

    def __init__(self, accum: int, accum_max: int):
        self._accum = accum
        self._accum_max = accum_max
        self._keys: list[str] = []
        self._cnt_accum = 0

    def push(self, key: str, msg, process: Callable[[], None],
             accumulate: Callable[[object], bool],
             clear: Callable[[], None]) -> None:
        if len(self._keys) < self._accum_max:
            if not self._keys or self._keys[0] != key:
                if accumulate(msg):
                    if not self._keys:
                        self._cnt_accum = 1
                    self._keys.append(key)
                else:
                    clear()
                    self.reset()
                return
            if self._cnt_accum < self._accum:
                if accumulate(msg):
                    self._cnt_accum += 1
                    self._keys.append(key)
                else:
                    clear()
                    self.reset()
                return
            # Received (accum + 1) clouds of the first key: fall through.
        # else: overflow guard — sensor with self._keys[0] may have stopped.

        process()
        clear()
        self.reset()
        if accumulate(msg):
            self._keys.append(key)
            self._cnt_accum += 1

    def reset(self) -> None:
        self._keys.clear()
        self._cnt_accum = 0

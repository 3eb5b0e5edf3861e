"""The checkpoint engine: the storage backend behind the training engine's
``save_checkpoint``/``load_checkpoint`` (the port of the native engine of
``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``).

``NativeCheckpointEngine`` writes the format-3 layout of
``checkpoint/saver.py`` and keeps one save in flight at a time: a new save,
a load and ``commit()`` first finish the pending one. Its pinned staging
buffer for async snapshots is allocated at the first async save and reused.
An async save in flight is committed at interpreter exit if nothing commits
it before; the exit hook is registered per pending save and dropped at
``commit()``, so an engine with nothing pending (and its pinned buffer) is
freed with its owner.
The orbax engine is not ported (``checkpoint.engine`` other than native is
refused by the config).
"""

from __future__ import annotations

import atexit
from typing import Optional

from ...checkpoint import saver


class NativeCheckpointEngine:
    def __init__(self):
        self._pending: Optional[saver.SaveHandle] = None
        self.staging = saver.HostStaging()

    def save(self, ckpt_dir: str, state, client_state: dict, async_save: bool = False,
             latest: Optional[tuple] = None) -> saver.SaveHandle:
        self.commit()  # one in-flight save at a time
        self._pending = saver.save_checkpoint(ckpt_dir, state, client_state=client_state, latest=latest,
                                              async_save=async_save, staging=self.staging)
        if async_save:
            atexit.register(self.commit)
        else:
            self.commit()
        return self._pending

    def load(self, ckpt_dir: str, state_like, verify: bool = True):
        return saver.load_checkpoint(ckpt_dir, state_like, verify=verify)

    def commit(self):
        """Finish the pending save: join its writer, then write its manifest
        and 'latest'. A write error of that save is raised here, once: the
        pending handle is dropped first, so the next save starts clean."""
        pending, self._pending = self._pending, None
        if pending is not None:
            atexit.unregister(self.commit)
            pending.wait()
        return True


def get_checkpoint_engine(name: Optional[str]) -> NativeCheckpointEngine:
    name = (name or "native").lower()
    if name == "native":
        return NativeCheckpointEngine()
    raise NotImplementedError(f"checkpoint engine {name!r} is not ported to deepspeed_tpu_torch (native only)")

"""Persistent state of the port: tree checkpoints and keyed blobs
(:mod:`.store`)."""
from .store import (AsyncCheckpointer, LockTimeout, blob_lock,
                    delete_blob, gc_checkpoints, latest_step, list_blobs,
                    load_blob, restore_checkpoint, save_blob,
                    save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "gc_checkpoints",
           "save_blob", "load_blob", "list_blobs", "delete_blob",
           "blob_lock", "LockTimeout"]

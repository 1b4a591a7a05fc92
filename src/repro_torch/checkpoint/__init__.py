"""Persistent state of the port: keyed blobs (:mod:`.store`)."""
from .store import (LockTimeout, blob_lock, delete_blob, list_blobs,
                    load_blob, save_blob)

__all__ = ["save_blob", "load_blob", "list_blobs", "delete_blob",
           "blob_lock", "LockTimeout"]

"""The port's `utils/fswatch.py` (inotify `FileWatcher`), held to the JAX
package's copy on the same file operations: both wake on a write, time out
without one, see an atomic rename, ignore other files in the directory and
sleep out the timeout when inotify is unavailable."""

import ctypes
import threading
import time

import pytest

from medical_image_editing_tpu.utils import fswatch as jfs
from medical_image_editing_tpu_torch.utils import fswatch as tfs


@pytest.fixture(params=["port", "jax"])
def watcher_cls(request):
    return {"port": tfs, "jax": jfs}[request.param].FileWatcher


def test_fswatch_wakes_on_write(tmp_path, watcher_cls):
    target = tmp_path / "edited.nii"
    target.write_bytes(b"v0")
    with watcher_cls(str(target)) as w:
        assert w.active  # Linux: inotify must engage

        def writer():
            time.sleep(0.05)
            target.write_bytes(b"v1")

        th = threading.Thread(target=writer)
        th.start()
        t0 = time.monotonic()
        assert w.wait(5.0) is True  # woke on the write...
        assert time.monotonic() - t0 < 1.0  # ...not on the timeout
        th.join(timeout=5)
        assert not th.is_alive()


def test_fswatch_times_out_without_write(tmp_path, watcher_cls):
    target = tmp_path / "edited.nii"
    target.write_bytes(b"v0")
    with watcher_cls(str(target)) as w:
        t0 = time.monotonic()
        assert w.wait(0.1) is False
        assert time.monotonic() - t0 >= 0.09


def test_fswatch_sees_atomic_rename(tmp_path, watcher_cls):
    target = tmp_path / "edited.nii"
    target.write_bytes(b"v0")
    with watcher_cls(str(target)) as w:
        other = tmp_path / "tmp_new"
        other.write_bytes(b"v1")
        assert w.wait(0.2) is False  # another file's write is not the map's
        other.rename(target)
        assert w.wait(5.0) is True


def test_fswatch_close_is_idempotent(tmp_path):
    w = tfs.FileWatcher(str(tmp_path / "edited.nii"))
    assert w.active
    w.close()
    w.close()
    assert not w.active
    t0 = time.monotonic()
    assert w.wait(0.05) is False  # a closed watcher sleeps
    assert time.monotonic() - t0 >= 0.04


def test_fswatch_sleeps_without_inotify(tmp_path, monkeypatch):
    """No libc (or no inotify): `active` is False and `wait` sleeps out its
    timeout, as the JAX copy does."""

    def no_libc(*args, **kw):
        raise OSError("libc not found")

    monkeypatch.setattr(ctypes, "CDLL", no_libc)
    for cls in (tfs.FileWatcher, jfs.FileWatcher):
        w = cls(str(tmp_path / "edited.nii"))
        assert not w.active
        t0 = time.monotonic()
        assert w.wait(0.05) is False
        assert time.monotonic() - t0 >= 0.04
        w.close()

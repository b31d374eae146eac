"""Linux inotify file watcher (ctypes, standard library only) with a sleeping
fallback.

The port's own copy of `medical_image_editing_tpu/utils/fswatch.py`. The
reference's editing server polls the edited NIfTI at 1 Hz (reference
`src/run_recon.py:230-238`), adding up to a second of edit-to-recon latency
on top of the decode. On Linux this waits on inotify instead: the kernel
wakes the loop when the editor finishes writing (CLOSE_WRITE) or atomically
replaces (MOVED_TO/CREATE) the file. Where inotify is unavailable, `wait`
sleeps; the caller's loop is unchanged either way.
"""

import ctypes
import ctypes.util
import errno
import os
import select
import struct
import time

IN_CLOSE_WRITE = 0x00000008
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_ATTRIB = 0x00000004
_EVENTS = IN_CLOSE_WRITE | IN_MOVED_TO | IN_CREATE | IN_ATTRIB

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


class FileWatcher:
    """Wake when `path` is (re)written. Usable as a context manager.

    wait(timeout) -> True if a relevant event arrived, False on timeout.
    Watches the parent directory so that an atomic replace by rename (the
    common editor save pattern) is seen too.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._dir = os.path.dirname(self.path) or "."
        self._base = os.path.basename(self.path).encode()
        self._fd = None
        try:
            libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                               use_errno=True)
            fd = libc.inotify_init1(os.O_NONBLOCK)
            if fd < 0:
                raise OSError(ctypes.get_errno(), "inotify_init1")
            wd = libc.inotify_add_watch(fd, self._dir.encode(), _EVENTS)
            if wd < 0:
                e = ctypes.get_errno()
                os.close(fd)
                raise OSError(e, f"inotify_add_watch({self._dir})")
            self._fd = fd
        except (OSError, AttributeError):  # no libc, no inotify: sleep instead
            self._fd = None

    @property
    def active(self) -> bool:
        """True when kernel notification is live (False: wait() just sleeps)."""
        return self._fd is not None

    def wait(self, timeout: float) -> bool:
        if self._fd is None:
            time.sleep(timeout)
            return False
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            r, _, _ = select.select([self._fd], [], [], remaining)
            if not r:
                return False
            if self._drain():
                return True

    def _drain(self) -> bool:
        """Read all queued events; True if any touches the watched file."""
        hit = False
        while True:
            try:
                buf = os.read(self._fd, 65536)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return hit
                raise
            off = 0
            while off + _EVENT_HDR.size <= len(buf):
                _, _, _, nlen = _EVENT_HDR.unpack_from(buf, off)
                name = buf[off + _EVENT_HDR.size: off + _EVENT_HDR.size + nlen]
                if name.split(b"\0", 1)[0] == self._base:
                    hit = True
                off += _EVENT_HDR.size + nlen

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

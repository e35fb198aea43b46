"""Durable file primitives shared by every on-disk seam.

The one lesson of the storage-fault plane: `os.replace` alone is NOT
durable. POSIX only promises the rename is on disk after the containing
DIRECTORY is fsynced — until then a power cut can resurrect the old file
(or leave neither). Every rename that guards consensus safety (privval
sign-state, WAL chunk rotation, config writes) must go through
`durable_replace`, which is also the `privval.save`/`wal.rotate`
disk-chaos seam.

The port's copy of cometbft_tpu/libs/diskio.py.
"""

from __future__ import annotations

import os
import tempfile


def fsync_dir(path: str) -> None:
    """fsync the directory containing `path` (or `path` itself when it is
    a directory) so a rename inside it survives power loss."""
    d = path if os.path.isdir(path) else os.path.dirname(os.path.abspath(path))
    fd = os.open(d or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def durable_replace(src: str, dst: str, site: str | None = None) -> None:
    """os.replace(src, dst) followed by an fsync of dst's directory. With
    `site` set, the whole operation runs through the disk-chaos seam
    (libs/diskchaos.fault_replace) so fault schedules can tear, lie
    about, or fail the rename deterministically."""
    if site is not None:
        from cometbft_tpu_torch.libs import diskchaos

        diskchaos.fault_replace(site, src, dst)
        return
    os.replace(src, dst)
    fsync_dir(dst)


def atomic_write_durable(path: str, data: bytes, site: str | None = None) -> None:
    """Write `data` to a same-directory temp file, fsync it, and
    durable_replace it over `path`: after this returns, either the old
    or the complete new content survives any crash — never a torn mix,
    and (unlike a bare os.replace) never neither."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        durable_replace(tmp, path, site=site)
    except Exception:
        # error paths clean the temp up; a SimulatedCrash (BaseException)
        # leaves it behind on purpose — a real power cut would too, and
        # loaders never read temp names
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise

"""Transparent decompression of input files via subprocess pipes (the
port's copy of ntcard_tpu/io/decompress.py).

The reference achieves this by interposing libc fopen/fopen64/open at link
time (Common/Uncompress.cpp:126-205) — fragile and unnecessary in a new
design. We keep the *same* extension -> filter-program table
(Uncompress.cpp:23-53) and the same fail-fast contract (a decompressor child
exiting non-zero aborts the whole run, like the SIGCHLD reaper in
Common/SignalHandler.cpp:32-62), but as an explicit stream-opening API.
"""

from __future__ import annotations

import io
import os
import shutil
import subprocess
from typing import IO, Optional

# Extension -> command table (order matters: first match wins), mirroring
# Common/Uncompress.cpp:32-53.
_ZCAT_TABLE = [
    (".ar", ["ar", "-p"]),
    (".tar", ["tar", "-xOf"]),
    (".tar.Z", ["tar", "-zxOf"]),
    (".tar.gz", ["tar", "-zxOf"]),
    (".tar.bz2", ["tar", "-jxOf"]),
    (".tar.xz", ["tar", "--use-compress-program=xzdec", "-xOf"]),
    (".Z", ["gunzip", "-c"]),
    (".gz", ["gunzip", "-c"]),
    (".bz2", ["bunzip2", "-c"]),
    (".xz", ["xzdec", "-c"]),
    (".zip", ["unzip", "-p"]),
    (".bam", ["samtools", "view", "-h"]),
    (".jf", ["jellyfish", "dump"]),
    (".jfq", ["jellyfish", "qdump"]),
    (".sra", ["fastq-dump", "-Z", "--split-spot"]),
    (".url", ["wget", "-O-", "-i"]),
]

_WGET_PREFIXES = ("http://", "https://", "ftp://")


def filter_command(path: str) -> Optional[list]:
    """The decompression/download command for ``path``, or None if the file
    should be read directly (Uncompress.cpp:23-53 semantics)."""
    for prefix in _WGET_PREFIXES:
        if path.startswith(prefix):
            return ["wget", "-O-", path]
    for ext, cmd in _ZCAT_TABLE:
        if path.endswith(ext):
            return cmd + [path]
    return None


class DecompressError(RuntimeError):
    pass


class _PipeStream(io.RawIOBase):
    """Binary stream over a decompressor subprocess's stdout.

    close() reaps the child; a non-zero exit status raises DecompressError
    (the reference's SIGCHLD handler exits the whole process on any child
    failure — callers translate this exception into a fatal error). Once
    the consumer has read to EOF, close() waits for the child: it may have
    closed its stdout without having exited yet, and its status must not
    be lost (the JAX package's copy kills it then)."""

    def __init__(self, cmd):
        if shutil.which(cmd[0]) is None:
            raise DecompressError(f"required filter program not found: {cmd[0]}")
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL
        )
        self._cmd = cmd
        self._eof = False

    def readable(self):
        return True

    def readinto(self, b):
        n = self._proc.stdout.readinto(b)
        if n == 0 and len(b):
            self._eof = True
        return n

    def close(self):
        if self.closed:
            return
        try:
            # Drain-free close: if the consumer stopped before EOF, kill the
            # child rather than deadlock on a full pipe.
            if not self._eof and self._proc.poll() is None:
                self._proc.stdout.close()
                self._proc.kill()
                self._proc.wait()
            else:
                self._proc.stdout.close()
                status = self._proc.wait()
                if status != 0:
                    raise DecompressError(
                        f"filter {' '.join(self._cmd)} exited with status {status}"
                    )
        finally:
            super().close()


def open_input(path: str, buffer_size: int = 1 << 20) -> IO[bytes]:
    """Open ``path`` for reading as a binary stream, transparently piping it
    through the decompressor/downloader selected by its extension."""
    cmd = filter_command(path)
    if cmd is None:
        return open(path, "rb", buffering=buffer_size)
    return io.BufferedReader(_PipeStream(cmd), buffer_size=buffer_size)


def input_size(path: str) -> int:
    """On-disk size used for the reference's <50 GB sBits auto-tune
    (ntcard.cpp:89-94, 427-431). Non-regular/remote inputs count as 0."""
    try:
        return os.path.getsize(path)
    except OSError:
        return 0

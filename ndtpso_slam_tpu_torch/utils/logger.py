"""Buffered file logger (C6 parity: `lib/ndtpso_slam/logger.cpp:4-32`).

A copy of ``ndtpso_slam_tpu/utils/logger.py`` (no JAX in it), kept in the
port so that it never imports the JAX package.

The reference ships a static line-buffered file logger, compiled out by
default (`USE_LOGGER false`, `config.h:13`).  Same capability here: disabled
unless constructed, flushes every ``buffer_lines`` lines and on close.
"""

from __future__ import annotations

from typing import List, Optional

LOGGER_BUFFER_SIZE_LINES = 50  # `config.h:16`


class BufferedLogger:
    def __init__(self, path: str, buffer_lines: int = LOGGER_BUFFER_SIZE_LINES):
        self._path = path
        self._buffer_lines = buffer_lines
        self._buf: List[str] = []
        self._f = open(path, "w")

    def write(self, line: str) -> None:
        self._buf.append(line.rstrip("\n"))
        if len(self._buf) >= self._buffer_lines:
            self._flush()

    def _flush(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._f.flush()
            self._buf.clear()

    def close(self) -> None:
        self._flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_global: Optional[BufferedLogger] = None


def init(path: str, buffer_lines: int = LOGGER_BUFFER_SIZE_LINES) -> None:
    """`MyLogger::init` equivalent (static global logger)."""
    global _global
    close()
    _global = BufferedLogger(path, buffer_lines)


def write(line: str) -> None:
    if _global is not None:
        _global.write(line)


def close() -> None:
    global _global
    if _global is not None:
        _global.close()
        _global = None

"""Logging utilities (``mx.log``; counterpart of ``mxnet_tpu/log.py``): a
level-coloured formatter and ``getLogger``, with the JAX package's format
(``<level letter><mmdd HH:MM:SS> <name>] <message>``) and levels."""
from __future__ import annotations

import logging
import sys

__all__ = ["getLogger", "get_logger"]

PY3 = True

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET


class _Formatter(logging.Formatter):
    """A formatter colouring the head by level on a terminal."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def _color(self, level):
        if level >= logging.ERROR:
            return "\x1b[31m"
        if level >= logging.WARNING:
            return "\x1b[33m"
        return "\x1b[32m"

    def format(self, record):
        date = self.formatTime(record, self.datefmt)
        head = "%s%s %s" % (record.levelname[0], date, record.name)
        if self.colored and sys.stderr.isatty():
            head = self._color(record.levelno) + head + "\x1b[0m"
        return "%s] %s" % (head, record.getMessage())


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger with one handler of this format (a file's, or stderr's);
    a second call for the same name only sets the level."""
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        logger.setLevel(level)
        return logger
    logger._init_done = True
    if filename:
        mode = filemode if filemode else "a"
        hdlr = logging.FileHandler(filename, mode)
        hdlr.setFormatter(_Formatter(colored=False))
    else:
        hdlr = logging.StreamHandler()
        hdlr.setFormatter(_Formatter())
    logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger


get_logger = getLogger

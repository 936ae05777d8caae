"""Structured logging (replaces [recbole] init_logger): console +
optional jsonl file sink for per-epoch metrics."""

from __future__ import annotations

import json
import logging
import os
import time

_LOGGER_NAME = "recbole_gnn_tpu_torch"


def init_logger(config) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.handlers.clear()
    level = getattr(logging, str(config["state"] or "INFO").upper(), logging.INFO)
    logger.setLevel(level)
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S"))
    logger.addHandler(h)
    logger.propagate = False
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


class JsonlSink:
    """Append-only jsonl metric log."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: dict):
        if not self.path:
            return
        record = dict(record, ts=time.time())
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record, default=str) + "\n")

"""Logging configuration.

Ports bigdl_tpu/utils/logger_filter.py (reference: utils/
LoggerFilter.scala — `redirectSparkInfoLogs` mutes Spark INFO chatter to
a `bigdl.log` file while keeping framework logs on the console). The
noisy loggers are the port's own: torch's where the JAX package names
jax's.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

# the chatty third-party loggers we demote (the reference's equivalent
# list was org.apache.spark.*)
_NOISY = ("torch._dynamo", "torch", "absl", "tensorflow", "h5py")


def redirect_logs(path: Optional[str] = None,
                  noisy: Sequence[str] = _NOISY,
                  console_level: int = logging.INFO) -> None:
    """Send noisy third-party INFO logs to `path` (default ./bigdl.log)
    instead of the console; framework loggers keep logging to console.

    Mirrors LoggerFilter.redirectSparkInfoLogs: chatter is preserved in
    the file for debugging but doesn't drown the training iteration log.
    """
    path = path or os.path.join(os.getcwd(), "bigdl.log")
    file_handler = logging.FileHandler(path)
    file_handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s - %(message)s"))
    for name in noisy:
        lg = logging.getLogger(name)
        lg.handlers = [file_handler]
        lg.propagate = False
        lg.setLevel(logging.INFO)

    root = logging.getLogger()
    if not root.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s - %(message)s"))
        root.addHandler(console)
    root.setLevel(console_level)

"""Logging controls (port of ``apex_tpu/transformer/log_util.py``)."""

import logging
import os

_LOGGER_NAME = "apex_tpu_torch.transformer"


def get_transformer_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    return logging.getLogger(name)


def set_logging_level(verbosity) -> None:
    """Set the transformer-subsystem logging level (ref log_util.py
    set_logging_level)."""
    logging.getLogger(_LOGGER_NAME).setLevel(verbosity)


# Same env knob the reference honors for one-time warnings.
_warned = set()


def warn_once(logger: logging.Logger, msg: str) -> None:
    if msg not in _warned and not os.environ.get("APEX_TPU_SILENCE_WARNINGS"):
        _warned.add(msg)
        logger.warning(msg)

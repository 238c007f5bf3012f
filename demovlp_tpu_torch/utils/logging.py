"""Run-directory logging: a console handler plus a rotating `info.log`
(counterpart of demovlp_tpu/utils/logging.py, the reference's
logger/logger.py with its logger_config.json built in)."""
from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

_FMT_CONSOLE = "%(message)s"
_FMT_FILE = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def setup_logging(save_dir, filename: str = "info.log", level=logging.INFO) -> None:
    """Configure the root logger: console at `level`, and `save_dir/filename`
    at INFO (10 MB a file, 20 backups). Handlers set up before are removed,
    so a second call (a second run in one process) does not duplicate lines;
    the file handlers among them are closed."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)
        if isinstance(h, logging.FileHandler):
            h.close()

    console = logging.StreamHandler()
    console.setLevel(level)
    console.setFormatter(logging.Formatter(_FMT_CONSOLE))
    root.addHandler(console)

    fileh = logging.handlers.RotatingFileHandler(
        save_dir / filename, maxBytes=10 * 1024 * 1024, backupCount=20, encoding="utf8")
    fileh.setLevel(logging.INFO)
    fileh.setFormatter(logging.Formatter(_FMT_FILE))
    root.addHandler(fileh)


def get_logger(name: str, verbosity: int = 2) -> logging.Logger:
    log_levels = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}
    if verbosity not in log_levels:
        raise ValueError(f"verbosity {verbosity} invalid; options: {list(log_levels)}")
    logger = logging.getLogger(name)
    logger.setLevel(log_levels[verbosity])
    return logger

"""JSON and JSON-lines readers (copy of the two readers of
demovlp_tpu/utils/io.py)."""
from __future__ import annotations

import json
from typing import Any


def load_json(filename) -> Any:
    with open(filename, "r") as f:
        return json.load(f)


def load_jsonl(filename) -> list:
    with open(filename, "r") as f:
        return [json.loads(line.strip("\n")) for line in f.readlines()]

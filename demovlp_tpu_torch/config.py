"""Experiment config (cut-down counterpart of demovlp_tpu/config.py).

Reads the repo's JSON experiment files (`configs/*.json`) as they are, as
plain dicts, and parses the `-c/-r` command line. Unlike the JAX package it
makes no run directories and writes no logs; `-r` names a reference-schema
`.pth` of weights, not a trainer checkpoint directory.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict


def build_argparser(description: str = "demovlp_tpu_torch") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", required=True, type=str, help="config file path")
    p.add_argument("-r", "--resume", default=None, type=str,
                   help="reference-schema .pth of weights (default: seeded random init)")
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random init")
    return p


def read_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)

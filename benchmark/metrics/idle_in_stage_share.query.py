"""idle_in_stage_share.query: the share of the traced window's device idle
time during which the main thread was inside the program's `serve.stage`
span (harness/program_spans.py)."""
from benchmark.harness import program_spans


def read(w):
    return program_spans.idle_share_inside(w, "query", "serve.stage")

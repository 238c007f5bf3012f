"""stage_ms_per_call.query: the host's time a query call in the program's
`serve.stage` spans (sharded_local_sims padding, pinning and enqueueing
the gallery chunks and caption blocks) in the traced window
(harness/program_spans.py)."""
from benchmark.harness import program_spans


def read(w):
    return program_spans.ms_per(w, "query", "serve.stage", "calls")

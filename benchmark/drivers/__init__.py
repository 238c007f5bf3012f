"""One driver per kind of traffic, loaded by name (harness/spec.py)."""

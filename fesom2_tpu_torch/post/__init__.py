"""Post-processing of a run's output (``post/fcheck.py``: the golden means)."""

"""Output quality gates (``validators``)."""

"""Restore bookkeeping: the checkpoint store (``checkpoint``)."""

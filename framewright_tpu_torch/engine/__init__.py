"""Restore bookkeeping: the checkpoint store (``checkpoint``) and the
long-form anchors and drift correction (``temporal``)."""

"""Data parallelism across processes (``ddp.py``)."""

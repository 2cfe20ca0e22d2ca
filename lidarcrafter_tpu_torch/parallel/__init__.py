"""Data parallelism across processes (``ddp.py``) on a (dp, sp) mesh whose
``sp`` axis splits the range images' azimuth (``mesh.py``)."""

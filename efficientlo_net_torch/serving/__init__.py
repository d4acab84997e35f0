"""Deployment artifacts of the port (``export.py``)."""

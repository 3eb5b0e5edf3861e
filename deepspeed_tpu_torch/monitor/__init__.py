"""Monitoring backends (``monitor.py``)."""

"""Launchers: the serving driver (`launch/serve.py`)."""

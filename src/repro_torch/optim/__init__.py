"""The optimizer (``adamw``)."""

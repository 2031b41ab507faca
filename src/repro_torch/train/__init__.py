"""Serving step builders (training is not ported yet)."""

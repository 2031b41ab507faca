"""Durable checkpoint store and the background snapshotter (DESIGN.md §3,
§11): the PyTorch port of ``repro.store``."""

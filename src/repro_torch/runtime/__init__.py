"""The fault-tolerance runtime (``ft``)."""

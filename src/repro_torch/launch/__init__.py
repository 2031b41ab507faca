"""Entry points: serving (``serve``)."""

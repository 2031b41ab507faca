"""Train and serve step builders (``steps``)."""

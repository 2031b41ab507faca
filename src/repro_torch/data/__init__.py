"""The synthetic, restart-skippable data pipeline (``pipeline``)."""

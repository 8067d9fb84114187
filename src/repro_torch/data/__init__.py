"""The deterministic synthetic data pipeline (``repro/data``)."""

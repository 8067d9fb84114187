"""Serving engine of the port (prefill/decode split)."""

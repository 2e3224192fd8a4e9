"""Serving steps (training waits for a later slice)."""

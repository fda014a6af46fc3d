"""Serving steps of the LM (training comes with a later slice)."""

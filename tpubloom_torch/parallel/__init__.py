"""Filters spread over several slots of device memory (the sharded filter array)."""

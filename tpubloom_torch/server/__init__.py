"""The port's wire clients (the RESP client of the Redis checkpoint sink)."""

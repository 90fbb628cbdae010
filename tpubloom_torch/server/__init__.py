"""The port's gRPC server (:mod:`tpubloom_torch.server.service`), its wire
(``protocol``), client, ingest coalescer and streams, and the RESP client
of the Redis checkpoint sink (``resp``)."""

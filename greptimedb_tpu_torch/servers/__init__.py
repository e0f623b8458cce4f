"""Server-side entry points of the port, as plain functions: the push
path (``ingest``, with the wire parsing of ``protocols``) and the
log-query DSL (``logquery``).  The HTTP, gRPC, MySQL and PostgreSQL
servers themselves are not ported yet."""

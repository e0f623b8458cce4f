"""Distributed-plan helpers.  Only ``partial`` (the commutativity split and
the partial-state merge) is ported: the streaming flow engine shares it.
The Flight services wait for the servers slice."""

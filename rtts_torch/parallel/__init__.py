"""Data and tensor parallelism for the port: process groups, sharding
rules, the sharded train step and sharded serving (``rtts/parallel/``'s
``mesh``, ``sharding`` and ``serving``; sequence and pipeline parallelism
are not ported yet)."""

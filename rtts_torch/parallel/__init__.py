"""Parallelism for the port: process groups, sharding rules, the sharded
train step, sharded serving, and stacks that split their sequence or their
layers over the model group (``rtts/parallel/``'s ``mesh``, ``sharding``,
``serving``, ``seq_parallel`` and ``pipeline``)."""

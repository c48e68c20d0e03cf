"""Parallelism: the data-parallel mesh over local devices (``mesh``: its
``make_mesh``, ``shard_batch`` and sharded steps) and scale-out across
processes, with contig-shard plans and the multi-host rendezvous
(``distributed``)."""

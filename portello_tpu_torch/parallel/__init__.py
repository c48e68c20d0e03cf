"""Scale-out across processes: contig-shard plans and the multi-host rendezvous."""

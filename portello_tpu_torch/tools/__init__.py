"""Companion tools of the port: ``python -m portello_tpu_torch.tools.merge``
concatenates unsorted BAM shards (the merge after ``--local-workers`` or a
multi-host run)."""

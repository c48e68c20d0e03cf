"""Companion tools of the port, for the steps around a liftover run:

- ``python -m portello_tpu_torch.tools.view``   BAM/CRAM -> SAM text
- ``python -m portello_tpu_torch.tools.index``  build a .bai (``--csi``
  for contigs past 2^29, a .crai for a CRAM): the CLI needs indexed inputs
- ``python -m portello_tpu_torch.tools.merge``  concatenate unsorted BAM
  shards (the merge after ``--local-workers`` or a multi-host run)
- ``python -m portello_tpu_torch.tools.sort``   coordinate sort: the CLI
  writes unsorted outputs
"""

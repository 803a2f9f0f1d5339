"""Parallel layer of the PyTorch port: meshes, the streaming front-end and
the streaming receiver.

``mesh`` and ``distributed`` build meshes of ``torch.distributed`` ranks
(one rank per device) and place batches on them as DTensors; ``streaming``
scans every stride-aligned window of a continuous stream and finds packet
starts; ``receiver`` turns chunks of a stream into decoded packets.  Given
a mesh, the scan and the receivers shard a stream's time axis over its
``sp`` axis, with halos of the next ranks' leading samples gathered by one
``all_gather`` (the JAX package's ``shard_map`` with ``ppermute`` halos).
"""

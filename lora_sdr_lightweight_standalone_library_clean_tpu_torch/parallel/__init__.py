"""Streaming front-end and streaming receiver of the PyTorch port.

``streaming`` scans every stride-aligned window of a continuous stream and
finds packet starts; ``receiver`` turns chunks of a stream into decoded
packets.  One device: the JAX package's ``mesh``/``axis`` sharding of the
scan (``shard_map`` with ``ppermute`` halos) waits for the port's
``torch.distributed`` layer.
"""

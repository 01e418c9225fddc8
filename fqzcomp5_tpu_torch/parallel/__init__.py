"""Scale-out of the port: a device mesh for the wave engine's walks
(``pipeline``) and multi-process encode and decode over
``torch.distributed`` (``distributed``, ``dist_cuda``)."""

"""Scale-out over several devices and processes: the chunk-parallel build,
probe and full step on ``torch.distributed`` (``sharded``), the Reader
with its rows split over devices (``reader``), the sharded-manifest index
format (``manifest``) and the multi-process Reader (``multihost``)."""

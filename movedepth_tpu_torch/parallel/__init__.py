"""Data-parallel training of the port across processes (port of the data
axis of ``movedepth_tpu/parallel``): ``dist`` (process group, broadcast,
gradient and scalar all-reduces) and ``sync_bn`` (the global-batch
BatchNorm)."""

"""Host-side data of the port: KITTI datasets, the batch loader and
synthetic batches."""

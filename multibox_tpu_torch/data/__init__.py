"""Input side of the port: tfrecords, the Example codec, JPEG decode, the
batched datasets and the host prefetcher (host numpy), and the on-device
augmentation and eval preprocessing (``augment``)."""

"""Host-side data: synthetic MNIST, peer partitions, per-peer batch streams."""

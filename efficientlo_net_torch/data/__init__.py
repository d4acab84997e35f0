"""KITTI dataset, prefetching loader, synthetic scans and batches, training
augmentation, int16 point transfer."""

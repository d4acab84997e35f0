"""Synthetic scans and batches, training augmentation, int16 point transfer."""

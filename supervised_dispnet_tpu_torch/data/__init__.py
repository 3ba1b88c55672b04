"""Packed-dataset readers, the batch loader and on-device augmentation."""

"""On-device augmentation."""

"""Task wiring: the detection train step and its augmentation."""

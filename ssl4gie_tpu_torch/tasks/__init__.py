"""Task wiring: the detection train step and its augmentation, and the
segmentation task."""

"""Task wiring: the detection train step and its augmentation, and the
segmentation and depth tasks."""

"""Task wiring: `build_trainer` (`tasks.build`), the held-out evaluators
(`tasks.evaluate`), the detection train step and its augmentation, and the
segmentation and depth tasks."""

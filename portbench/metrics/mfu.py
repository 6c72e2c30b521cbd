"""The whole step's share of the card's bf16 peak: the model's FLOPs an
image (`work.py`: forward matmuls at 2 a MAC, times 3, no recompute) times
the window's images per second, over 989 TFLOP/s, in %."""

from portbench import work
from portbench.metrics import train_images_per_s


def read(rec: dict):
    return (100.0 * rec["flops_per_image"] * train_images_per_s.read(rec)
            / work.PEAK_BF16_FLOPS)

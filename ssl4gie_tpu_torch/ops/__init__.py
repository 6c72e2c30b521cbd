"""Box, NMS, resize and RoIAlign ops of the detection stack."""
